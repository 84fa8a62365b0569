"""The detection configuration built on either side: ``sides.Recipe``'s
model, weights and train state, with the det train step instead of the
keypoint one: the program's ``train/det_solver.py::make_det_train_step``
(the step ``DetSolver`` runs) or the plain reference's
``train/det_steps.py``, and each side's assignment solver, which the output
check records and follows.
"""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import harness
import sides

# module role -> module path on each side
MODULES = {
    "program": {"step": "train.det_solver", "criterion": "losses.det_criterion",
                "denoising": "models.denoising"},
    "reference": {"step": "train.det_steps", "criterion": "losses.det_criterion",
                  "denoising": "models.denoising", "matcher": "losses.det_matcher"},
}


class DetRecipe(sides.Recipe):
    """One detection configuration (``configs/<name>.json`` and ``.py``)
    built on one side; ``det`` holds that side's det modules."""

    def __init__(self, torch, name: str, side: str, spec: dict | None = None):
        super().__init__(torch, name, side, spec)
        root = {"program": harness.PROGRAM, "reference": sides.REFERENCE}[side]
        self.det = SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                                      for k, v in MODULES[side].items()})

    @property
    def match_site(self):
        """(module, function name) of the side's assignment solver: the
        program's batched Hungarian or the reference's scipy matcher."""
        if self.pkg.side == "program":
            return self.det.criterion, "hungarian"
        return self.det.matcher, "assign"

    def train_step(self, tcfg, compute_dtype):
        crit = self.det.criterion.DetCriterionConfig(**self.spec["criterion"])
        return self.det.step.make_det_train_step(
            crit, tcfg, denoising=self.module.denoising(self.spec), compute_dtype=compute_dtype)
