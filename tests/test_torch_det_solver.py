"""PyTorch port, the detection task end to end on the CPU: ``DetSolver``'s
fit (2 epochs, tiny widths) and val on a rendered synthetic COCO set
(finite losses, ``log.txt`` with the JAX package's keys, the checkpoints,
a resumed run), ``tools/train.py`` on a detection config (``--test-only``
printing the COCO stat dict, with and without ``-r``),
``tools/synthetic_det_selfcheck``'s ``main``, and ``TASKS``. The JAX
package's DetSolver runs one epoch of the same config for its log keys."""
import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp

import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.core.yaml_config import YAMLConfig as JaxYAMLConfig
from satellite_pose_estimation_tpu.train import det_solver as jds
from satellite_pose_estimation_tpu.train import state as jax_state
from satellite_pose_estimation_tpu.train.det_solver import DetSolver as JaxDetSolver
from satellite_pose_estimation_tpu.train.ema import ema_init as jax_ema_init
from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
from satellite_pose_estimation_tpu_torch.models.rtdetr import RTDETR, RTDETRConfig
from satellite_pose_estimation_tpu_torch.tools import synthetic_det_selfcheck as selfcheck
from satellite_pose_estimation_tpu_torch.tools import train as train_cli
from satellite_pose_estimation_tpu_torch.train.det_solver import DetSolver
from satellite_pose_estimation_tpu_torch.train.solver import TASKS

from _torch_parity import port_to_flax
from _torch_parity import one_thread  # noqa: F401,E402 (autouse: one torch thread)

SIZE = 64


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_det"))
    selfcheck.render_dataset(root, 4, seed=0, img_size=64)  # 4 train, 8 val images
    return root


def _config(out, epochs=2):
    """A tiny det config: PResNet-18, hidden 32, 8 queries, 2 decoder
    layers, CDN, the recipe's ops, multi-scale 32 / 64, batch 2."""
    return {
        "task": "detection", "num_classes": 2, "epoches": epochs, "checkpoint_step": 1,
        "output_dir": out, "use_ema": True, "ema": {"decay": 0.9, "warmups": 2},
        "PResNet": {"depth": 18, "freeze_norm": True},
        "HybridEncoder": {"hidden_dim": 32, "nhead": 2, "dim_feedforward": 64,
                          "expansion": 0.5},
        "RTDETRTransformer": {"num_queries": 8, "num_decoder_layers": 2, "num_denoising": 6},
        "RTDETR": {"multi_scale": [32, SIZE]},
        "optimizer": {"type": "AdamW", "lr": 1e-3,
                      "params": [{"params": "backbone", "lr": 1e-4}]},
        "train_dataloader": {"batch_size": 2, "dataset": {"resize": SIZE, "transforms": {
            "ops": [{"type": "RandomPhotometricDistort", "p": 0.5},
                    {"type": "RandomHorizontalFlip"},
                    {"type": "Resize", "size": [SIZE, SIZE]},
                    {"type": "SanitizeBoundingBox", "min_size": 1},
                    {"type": "ConvertBox", "out_fmt": "cxcywh", "normalize": True}]}}},
        "val_dataloader": {"batch_size": 4, "dataset": {"resize": SIZE}},
    }


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _jax_state_from_port_weights(model, rng, sample_input, cfg, backbone_predicate=None,
                                 tx=None):
    """The JAX package's ``create_train_state`` for an RT-DETR without
    running its init: the variables come from a seeded port model
    (``port_to_flax``), the frozen-norm prefixes from ``jax.eval_shape``."""
    pcfg = RTDETRConfig(**{k: v for k, v in dataclasses.asdict(model.config).items()
                           if k != "dtype"})
    x = jnp.zeros((1,) + tuple(sample_input.shape[1:]))
    jvars = port_to_flax(model, RTDETR(pcfg).state_dict(), x, train=False)
    frozen = jax_state.frozen_param_prefixes(
        jax.eval_shape(functools.partial(model.init, train=False), rng, x))
    params, stats = jvars["params"], jvars["batch_stats"]
    txf = tx(params, frozen)
    return jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jax.jit(txf.init)(params), ema_params=jax.jit(jax_ema_init)(params),
        ema_batch_stats=jax.jit(jax_ema_init)(stats), tx=txf, apply_fn=model.apply)


def test_det_solver_fit_val_resume_and_jax_log_keys(coco_root, tmp_path, monkeypatch):
    out = str(tmp_path / "port")
    solver = DetSolver(YAMLConfig(cfg=_config(out)), data_root=coco_root, seed=0, max_targets=3,
                       device="cpu")
    best = solver.fit()
    assert np.isfinite(best["AP"])  # {"AP": 0.0} until an epoch scores above 0, as in JAX
    entries = _log(out)
    assert {f"test_{k}" for k in ("AP", "AP50", "AP75", "AR1", "AR10", "AR100")} <= set(entries[0])
    assert [e["epoch"] for e in entries] == [0, 1]
    for e in entries:
        assert all(np.isfinite(v) for k, v in e.items() if k.startswith(("train_", "test_")))
    assert {"train_loss_total", "train_loss_vfl_dn_1", "test_AP"} <= set(entries[0])
    assert solver.timings["train"]["images"] == 4 and solver.timings["val"]["images"] == 8
    for name in ("checkpoint", "checkpoint0000", "checkpoint0001"):
        assert os.path.isfile(os.path.join(out, name, "state.pt"))

    # The JAX package's solver and the port's on a plainer config (one size,
    # no CDN: one JAX train program to compile; JAX's state made from port
    # weights, so its init does not run), one epoch: the same log.txt keys.
    keys = []
    monkeypatch.setattr(jds, "create_train_state", _jax_state_from_port_weights)
    for name, make in (("jax", lambda c: JaxDetSolver(JaxYAMLConfig(cfg=c), mesh=False,
                                                      data_root=coco_root, max_targets=3)),
                       ("port", lambda c: DetSolver(YAMLConfig(cfg=c), device="cpu",
                                                    data_root=coco_root, max_targets=3))):
        cfg = _config(str(tmp_path / f"{name}_keys"), epochs=1)
        del cfg["RTDETR"], cfg["RTDETRTransformer"]["num_denoising"]
        make(cfg).fit()
        keys.append(set(_log(str(tmp_path / f"{name}_keys"))[0]))
    assert keys[0] == keys[1] and "train_loss_vfl_1" in keys[0], keys[0] ^ keys[1]

    # A resumed solver restores the whole state and starts after it.
    again = DetSolver(YAMLConfig(cfg=_config(out)), data_root=coco_root, seed=0,
                      max_targets=3, device="cpu")
    again.resume(os.path.join(out, "checkpoint"))
    again._build()
    assert again.start_epoch == 2 and again.state.step == solver.state.step == 4
    for k, v in solver.state.model.state_dict().items():
        assert torch.equal(again.state.model.state_dict()[k], v), k
    assert all(torch.equal(again.state.ema[k], v) for k, v in solver.state.ema.items())
    stats = again.val(build=False)
    assert stats == solver.val(build=False)


def test_train_cli_runs_a_detection_config(coco_root, tmp_path, capsys):
    """``tools/train.py``'s main on a detection config: ``--test-only``
    prints the COCO stat dict, of fresh weights and of a checkpoint that
    ``-r`` loads (its solver pads to the default 100 targets, so the fit
    that made the checkpoint runs ``DetSolver`` with 3)."""
    out = str(tmp_path / "cli")
    DetSolver(YAMLConfig(cfg=_config(out, epochs=1)), data_root=coco_root, seed=0,
              max_targets=3, device="cpu").fit()
    args = types.SimpleNamespace(config=_config(out, epochs=1), resume=None, tuning=None,
                                 test_only=True, update=None, data_root=coco_root, seed=1,
                                 device="cpu")
    printed = []
    for resume in (None, os.path.join(out, "checkpoint")):
        args.resume = resume
        capsys.readouterr()
        solver = train_cli.main(args)
        assert isinstance(solver, DetSolver) and solver.start_epoch == (1 if resume else 0)
        printed.append(eval(capsys.readouterr().out.strip().splitlines()[-1],
                            {"__builtins__": {}}))  # the printed dict
    for stats in printed:
        assert set(stats) == {"AP", "AP50", "AP75", "AR1", "AR10", "AR100"}
        assert all(np.isfinite(v) for v in stats.values())


def test_synthetic_det_selfcheck_main(tmp_path):
    """The selfcheck CLI renders its set and fits it (one tiny epoch) on the
    CPU when asked; it defaults to the card."""
    args = selfcheck.get_args_parser().parse_args([
        "--root", str(tmp_path / "data"), "--out", str(tmp_path / "out"), "--n_images", "4",
        "--epochs", "1", "--batch", "2", "--resize", "32", "--device", "cpu"])
    best = selfcheck.main(args)
    assert np.isfinite(best["AP"]) and len(_log(str(tmp_path / "out"))) == 1
    assert selfcheck.get_args_parser().parse_args([]).device == "cuda"


def test_tasks_and_defaults(tmp_path):
    """TASKS routes the detection task to DetSolver; the solver runs on the
    card unless asked otherwise, and takes JAX's data-parallel ``mesh``
    (None: the launched world, one device outside a launcher)."""
    import inspect

    cfg = YAMLConfig(cfg=_config(str(tmp_path)))
    solver = TASKS["detection"](cfg)
    assert isinstance(solver, DetSolver) and solver.device == torch.device("cuda")
    assert inspect.signature(DetSolver).parameters["mesh"].default is None
