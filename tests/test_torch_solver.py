"""``SpeedSolver``, the R1 CLI's config and its ``.pth`` dispatch against
the JAX package, on the CPU with the tiny RT-DETR config of
tests/test_solver_integration.py over a rendered SPEED set:

* fit -> log.txt with the keys JAX's fit writes (and its parameter
  count) -> resume from the checkpoint (start_epoch 1; the resumed epoch's
  losses and lr equal an uninterrupted run's, 1e-6) -> tuning from it (every
  tensor shape-matched, the EMA re-seeded);
* ``val()`` with JAX's weights carried across against JAX's evaluation of
  the same state: per-image SPEED score atol 2e-3, probabilities 1e-4 and
  points 1e-4 of the crop (the eval-step parity of tests/test_torch_rtdetr.py,
  plus the evaluator log's rounding);
* ``args_to_config`` equal to JAX's dict; the ``--resume`` file-name rule.
"""
import argparse
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satellite_pose_estimation_tpu.core.yaml_config import YAMLConfig as JaxYAMLConfig
from satellite_pose_estimation_tpu.tools import main as jax_main
from satellite_pose_estimation_tpu.train import solver as jax_solver_module
from satellite_pose_estimation_tpu.train.solver import SpeedSolver as JaxSpeedSolver
from satellite_pose_estimation_tpu_torch.core.yaml_config import YAMLConfig
from satellite_pose_estimation_tpu_torch.tools import main as port_main
from satellite_pose_estimation_tpu_torch.tools.synthetic_selfcheck import render_dataset
from satellite_pose_estimation_tpu_torch.train.ema import ema_init
from satellite_pose_estimation_tpu_torch.train.solver import TASKS, SpeedSolver, count_parameters
from satellite_pose_estimation_tpu_torch.utils.checkpoint_convert import (
    flax_rtdetr_to_state_dict,
    r1_state_dict_to_port,
)
from test_solver_integration import TINY_CFG

from _torch_parity import numpy_tree, port_to_flax, r1_detr_state_dict


def _cfg(out, **over):
    cfg = copy.deepcopy(TINY_CFG)
    cfg["train_dataloader"]["dataset"]["index_file"] = "train_1.txt"
    cfg["val_dataloader"]["dataset"]["index_file"] = "val_1.txt"
    cfg.update(output_dir=str(out), **over)
    return cfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models here gain nothing from intra-op threads, and the
    tier-1 run's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def speed(tmp_path_factory):
    root = tmp_path_factory.mktemp("speed")
    render_dataset(str(root), 5, seed=4, n_train=3)  # one train step of 3, one val step of 2
    return str(root)


@pytest.fixture(scope="module")
def jax_solver(speed, tmp_path_factory):
    """JAX's solver on the same data and config, built and evaluated. Its
    variables are the port's seeded weights carried over (``port_to_flax``,
    nothing compiled) in place of its own init, which costs ~40 s here."""
    cfg = JaxYAMLConfig(cfg=_cfg(tmp_path_factory.mktemp("jax")))
    weights = YAMLConfig(cfg=_cfg("unused")).build_model(seed=11, device="cpu").state_dict()
    variables = port_to_flax(cfg.build_model(), weights, jnp.zeros((1, 64, 64, 3)), train=False)

    class Initialised:
        def __init__(self, model):
            self._model = model

        def init(self, *args, **kwargs):
            return variables

        def __getattr__(self, name):
            return getattr(self._model, name)

    real = jax_solver_module.create_train_state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_solver_module, "create_train_state",
                   lambda model, *a, **k: real(Initialised(model), *a, **k))
        solver = JaxSpeedSolver(cfg, data_root=speed, seed=0)
        solver._build()
    stats, evaluator = solver.evaluate()
    return solver, stats, evaluator


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_fit_resume_and_tuning(speed, jax_solver, tmp_path):
    jsolver, jstats, jevaluator = jax_solver
    # JAX's train step returns set_criterion's dict (train/steps.py:98-134),
    # its eval step the same dict with loss_total (:228-239): the loss names
    # of its evaluation are those of its train log.
    jloss_names = set(jstats) - set(jevaluator.scalar_summary())
    full, part = tmp_path / "full", tmp_path / "part"
    uninterrupted = SpeedSolver(YAMLConfig(cfg=_cfg(full, epoches=2)), speed, seed=0,
                                device="cpu")
    uninterrupted.fit()

    entry = _log(full)[0]
    expected = ({f"train_{k}" for k in jloss_names} | {"train_lr"}
                | {f"test_{k}" for k in jstats} | {"test_speed_eval_pose", "epoch",
                                                     "n_parameters"})
    assert set(entry) == expected
    assert entry["n_parameters"] == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jsolver.state.params))
    assert entry["n_parameters"] == count_parameters(uninterrupted.state.model)
    assert np.isfinite(entry["train_loss_total"]) and 0 <= entry["test_score"] <= 4.2
    for name in ("eval_0000_log.json", "scalars.json", "checkpoint", "checkpoint_best",
                 "checkpoint0000", "checkpoint0001"):
        assert os.path.exists(full / name), name
    assert len(json.loads((full / "eval_0000_log.json").read_text())) == 2

    # resume from the epoch-0 checkpoint: epoch 1 as the uninterrupted run ran it
    resumed = SpeedSolver(YAMLConfig(cfg=_cfg(part, epoches=2)), speed, seed=0, device="cpu")
    resumed.resume(str(full / "checkpoint0000"))
    resumed.fit()
    assert resumed.start_epoch == 1
    (got,), ref = _log(part), _log(full)[1]
    assert got["epoch"] == ref["epoch"] == 1
    assert {k for k in got if k.startswith("train_")} == {k for k in ref
                                                          if k.startswith("train_")}
    for k, v in ref.items():
        if k.startswith("train_"):
            assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
    assert got["train_lr"] == pytest.approx(1e-4)
    assert resumed.state.step == uninterrupted.state.step == 2
    assert resumed.state.ema is not None and all(v.dtype == torch.float32
                                                 for v in resumed.state.ema.values())

    tuned = SpeedSolver(YAMLConfig(cfg=_cfg(tmp_path / "tuned")), speed, seed=7, device="cpu")
    tuned.tuning(str(full / "checkpoint_best"))
    tuned._build()
    matched, total = tuned.tuning_counts
    assert matched == total
    src = torch.load(full / "checkpoint_best" / "state.pt", weights_only=True)
    state = tuned.state.model.state_dict()
    for k, v in src["ema"].items():  # the EMA weights, buffers included
        assert torch.equal(state[k], v), k
    for k, v in tuned.state.ema.items():  # re-seeded from them
        assert torch.equal(v, state[k].float()), k


def test_val_with_jax_weights_matches_jax(speed, jax_solver, tmp_path):
    """JAX's state's weights (and its EMA shadow, equal to them) carried into
    the port: ``val()`` through a tuning load of them gives JAX's
    per-image results."""
    jsolver, jstats, jevaluator = jax_solver
    carrier = SpeedSolver(YAMLConfig(cfg=_cfg(tmp_path / "a")), speed, seed=0, device="cpu")
    carrier._build()
    sd = flax_rtdetr_to_state_dict(numpy_tree(jsolver.state.params),
                                   numpy_tree(jsolver.state.batch_stats), freeze_norm=False)
    carrier.state.model.load_state_dict(sd)
    carrier.state.ema = ema_init(carrier.state.model)
    carrier.save_checkpoint(0, "from_jax")

    solver = SpeedSolver(YAMLConfig(cfg=_cfg(tmp_path / "b")), speed, seed=3, device="cpu")
    solver.tuning(str(tmp_path / "a" / "from_jax"))
    stats, evaluator = solver.val()
    assert solver.tuning_counts[0] == solver.tuning_counts[1]
    assert set(stats) == set(jstats) and stats["num_images"] == jstats["num_images"] == 2
    assert set(evaluator.log) == set(jevaluator.log)
    for name, ref in jevaluator.log.items():
        got = evaluator.log[name]
        assert got["valid"] == ref["valid"]
        assert got["score"] == pytest.approx(ref["score"], abs=2e-3), name
        np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-4, atol=1e-4 + 1e-6)
        extent = np.ptp(np.asarray(ref["points"]), axis=0).max() + 1.0
        np.testing.assert_allclose(got["points"], ref["points"], rtol=0,
                                   atol=1e-4 * max(extent, 400.0) + 1e-2)
    assert stats["score"] == pytest.approx(jstats["score"], abs=2e-3)
    assert stats["loss_total"] == pytest.approx(jstats["loss_total"], rel=1e-3)


def test_args_to_config_equals_jax():
    for argv in ([], ["--backbone", "resnet50s8", "--enc_layers", "4", "--dec_layers", "4",
                      "--num_queries", "20", "--input_size", "224", "--batch_size", "32",
                      "--compute_dtype", "bfloat16", "--lr_drop", "3", "--bn", "bn"]):
        args = port_main.get_args_parser().parse_args(argv)
        jargs = jax_main.get_args_parser().parse_args(argv)
        assert port_main.args_to_config(args).yaml_cfg == jax_main.args_to_config(jargs).yaml_cfg
        assert vars(args) == {**vars(jargs), "device": "cuda"}


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda path: self.calls.append((name, path))


@pytest.mark.parametrize("path, kind", [
    ("detr-r50-e632da11.pth", "surgery"),
    ("/weights/detr-r50-e632da11.pth", "surgery"),
    ("/weights/detr-r50.pth", "r1"),
    ("output/r1/checkpoint0149.pth", "r1"),
    ("output/r1/checkpoint", "resume"),
    ("output/r1/checkpoint/", "resume"),
])
def test_resume_dispatch_follows_the_reference(path, kind):
    """The public DETR-R50 file name goes through surgery (R1/main.py:270),
    any other .pth is a whole R1 model, the rest a checkpoint to resume; not
    JAX's rule of surgery on every .pth."""
    rec = _Recorder()
    assert port_main.attach_checkpoint(rec, path) == kind
    assert rec.calls == [({"surgery": "surgery", "r1": "load_r1", "resume": "resume"}[kind],
                          path)]


def test_r1_cli_evaluates_an_r1_pth(speed, tmp_path):
    """``--resume x.pth --eval`` through the R1 CLI's ``main``: the model
    holds the R1 file's weights, renamed."""
    rng = np.random.RandomState(5)
    sd = r1_detr_state_dict("resnet18", 32, 4, 1, 1, 64, 12, rng)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": argparse.Namespace(backbone="resnet18")}, tmp_path / "r1_model.pth")
    argv = ["--backbone", "resnet18", "--hidden_dim", "32", "--nheads", "4", "--enc_layers",
            "1", "--dec_layers", "1", "--dim_feedforward", "64", "--num_queries", "12",
            "--input_size", "64", "--batch_size", "2", "--data_root", speed, "--output_dir",
            str(tmp_path / "out"), "--resume", str(tmp_path / "r1_model.pth"), "--eval",
            "--device", "cpu"]
    solver = port_main.main(port_main.get_args_parser().parse_args(argv))
    state = solver.state.model.state_dict()
    want = r1_state_dict_to_port(sd)
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    assert solver.timings["val"]["images"] == 2


def test_solver_defaults_to_the_card_and_tasks(speed, tmp_path):
    """A solver runs on the card unless asked otherwise: without a card its
    build raises (tests/test_torch_cuda.py builds it on one). The detection
    task is not ported yet and says so."""
    cfg = YAMLConfig(cfg=_cfg(tmp_path))
    solver = SpeedSolver(cfg, speed)
    assert solver.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            solver._build()
    with pytest.raises(NotImplementedError, match="slice 7"):
        TASKS["detection"](cfg)
    assert TASKS["landmarker"] is SpeedSolver
