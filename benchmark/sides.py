"""The two sides a cell builds from one configuration: the program
(``satellite_pose_estimation_tpu_torch``, the system under test) and the
plain reference (``reference/spe_ref``, a frozen copy of the program's
modules with every kernel route taken out). Both expose the same modules,
so one configuration file builds either.
"""
from __future__ import annotations

import importlib
import math
from types import SimpleNamespace

from harness import PROGRAM, config_module, config_spec
import inputs

REFERENCE = "spe_ref"
MODULES = {
    "detr": "models.detr", "rtdetr": "models.rtdetr", "steps": "train.steps",
    "state": "train.state", "optim": "train.optim", "criterion": "losses.criterion",
    "augment": "data.augment", "solvers": "geometry.solvers", "camera": "geometry.camera",
    "scoring": "geometry.scoring", "image_warp": "ops.image_warp",
    "decoder": "models.rtdetr_decoder", "matcher": "losses.matcher",
}


def package(side: str) -> SimpleNamespace:
    """The modules of ``side`` ("program" or "reference")."""
    root = {"program": PROGRAM, "reference": REFERENCE}[side]
    ns = SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}") for k, v in MODULES.items()})
    ns.side = side
    return ns


class Recipe:
    """One configuration (``configs/<name>.json`` and ``.py``) built on one
    side: its model from a seed, its eval step, its train state and step,
    all as the program's CLIs build them from the same YAML."""

    def __init__(self, torch, name: str, side: str, spec: dict | None = None):
        self.torch = torch
        self.name = name
        self.spec = spec if spec is not None else config_spec(name)
        self.module = config_module(name)
        self.pkg = package(side)

    @property
    def selector(self):
        """The module whose ``topk`` selects the decoder's queries, for a
        configuration whose model selects them (None otherwise)."""
        return self.pkg.decoder if getattr(self.module, "SELECTS_QUERIES", False) else None

    @property
    def scaled(self):
        """(regex, factor) pairs of the leaves the configuration scales."""
        return [(r["match"], r["factor"]) for r in self.spec.get("weights", {}).get("scale", [])]

    @property
    def draws_dropout(self) -> bool:
        """Whether the configuration's model draws dropout in training."""
        return getattr(self.module.model_config(self.pkg, self.spec), "dropout", 0.0) > 0

    @property
    def compute_dtype(self):
        """The autocast dtype the configuration states (None: float32)."""
        name = self.spec["compute_dtype"]
        return None if name == "float32" else getattr(self.torch, name)

    @property
    def world(self):
        return self.torch.tensor(self.pkg.camera.WORLD_POINTS, dtype=self.torch.float32)

    def model(self, seed: int, device, train: bool):
        """The configuration's model with float32 parameters filled from
        ``seed`` on ``device``, in training or eval mode."""
        cfg = self.module.model_config(self.pkg, self.spec)
        model, names = inputs.build_filled(
            self.torch, lambda: self.module.model_class(self.pkg)(cfg), seed, device,
            self.scaled)
        model.train(train)
        return model, names

    def eval_step(self, compute_dtype):
        pkg, s = self.pkg, self.spec
        return pkg.steps.make_eval_step(
            solver_cfg=pkg.solvers.SolverConfig(input_size=s["input_size"]),
            out_size=s["input_size"], solver=s["solver"], compute_dtype=compute_dtype)

    def train_state(self, model, batch_size: int):
        """(state, step) with the recipe's optimizer groups, schedule, clip
        and EMA; the steps of an epoch from the split's size and the
        batch."""
        pkg, s = self.pkg, self.spec
        tcfg = pkg.state.TrainConfig(**s["train"])
        steps_per_epoch = math.ceil(s["train_images"] / batch_size)
        tx = pkg.optim.build_optimizer(s["optimizer"], model, steps_per_epoch,
                                       s["lr_scheduler"], s["clip_max_norm"])
        state = pkg.state.create_train_state(model, tcfg, tx)
        return state, tcfg

    def train_step(self, tcfg, compute_dtype):
        pkg, s = self.pkg, self.spec
        crit = pkg.criterion.CriterionConfig(**s["criterion"])
        return pkg.steps.make_train_step(
            crit, tcfg, pkg.augment.AugmentConfig(out_size=s["input_size"]),
            denoising=self.module.denoising(self.spec), compute_dtype=compute_dtype)

    def pool(self, seed: int, count: int, batch: int, device, image=None):
        return inputs.batch_pool(self.torch, seed, count, batch, self.spec["pack_size"],
                                 self.world.to(device), device, image)
