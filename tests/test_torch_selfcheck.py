"""The synthetic SPEED self-check CLI (``tools/synthetic_selfcheck.py``'s
``main``): the config dict it fits equals the one JAX's ``main`` builds,
its tail reads ``log.txt`` as JAX's does, its flags are JAX's plus
``--device``, its renderer writes the index files ``main`` reads, and one
tiny epoch runs on the CPU. (tests/test_torch_yaml_config.py reads each
self-check config through both packages' readers.)"""
import ast
import json
import pathlib

import numpy as np
import pytest

from satellite_pose_estimation_tpu_torch.tools import synthetic_selfcheck as selfcheck
from satellite_pose_estimation_tpu_torch.train import solver as port_solver

from _torch_parity import jax_selfcheck, one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_CLI = ROOT / "satellite_pose_estimation_tpu/tools/synthetic_selfcheck.py"


def _args(tmp_path, *flags):
    return selfcheck.get_args_parser().parse_args(
        ["--root", str(tmp_path / "data"), "--out", str(tmp_path / "out"), *flags])


@pytest.mark.parametrize("preset", ["small", "flagship"])
@pytest.mark.parametrize("aug", ["full", "r1"])
def test_main_fits_the_config_jax_fits(preset, aug, tmp_path, monkeypatch, capsys):
    """For each preset and ``--aug`` recipe: ``build_config`` is the dict JAX's
    ``main`` hands its ``YAMLConfig``, key for key; the solver gets the same
    data root and seed; and over the same ``log.txt`` both ``main``s print
    the same final line and return the same best score."""
    args = _args(tmp_path, "--preset", preset, "--aug", aug, "--seed", "3", "--batch", "7",
                 "--resize", "96")
    jcfg, jax_best, jax_solver_args = jax_selfcheck(args, monkeypatch)
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert selfcheck.build_config(args) == jcfg.yaml_cfg
    assert jax_best == 1.5 and jax_solver_args == (args.root, 3)

    log_lines = (tmp_path / "out" / "log.txt").read_text()
    seen = {}

    class StandIn:
        def __init__(self, cfg, data_root, seed, device):
            seen.update(cfg=cfg.yaml_cfg, solver=(data_root, seed, device))

        def fit(self):
            (tmp_path / "out" / "log.txt").write_text(log_lines)

    monkeypatch.setattr(port_solver, "SpeedSolver", StandIn)
    best = selfcheck.main(args)
    assert capsys.readouterr().out.strip().splitlines()[-1] == jax_line
    assert best == jax_best and seen["cfg"] == jcfg.yaml_cfg
    assert seen["solver"] == (args.root, 3, "cuda")


def _jax_flags():
    """{flag: (type, default, choices, action)} of JAX's ``__main__`` parser,
    read from its source (it builds the parser inside the main guard)."""
    flags = {}
    for node in ast.walk(ast.parse(JAX_CLI.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) if k.arg != "type" else k.value.id
                  for k in node.keywords}
            default = kw.get("default", False if kw.get("action") == "store_true" else None)
            flags[node.args[0].value] = (kw.get("type"), default, kw.get("choices"),
                                         kw.get("action"))
    return flags


def test_parser_is_jax_flags_plus_device():
    """The port's flags are JAX's, with JAX's types, defaults and choices,
    plus ``--device`` defaulting to the card. The data and output defaults
    sit under ``output/`` in the working directory instead of JAX's
    ``/tmp/synthetic_speed``."""
    actions = {a.option_strings[0]: a for a in selfcheck.get_args_parser()._actions
               if a.option_strings and a.dest != "help"}
    jax_flags = _jax_flags()
    assert set(actions) == set(jax_flags) | {"--device"}
    assert actions["--device"].default == "cuda"
    moved = {"--root": "output/synthetic_speed", "--out": "output/synthetic_speed/out"}
    for flag, (typ, default, choices, action) in jax_flags.items():
        a = actions[flag]
        assert (a.type.__name__ if a.type else None) == typ, flag
        assert a.default == moved.get(flag, default), flag
        assert (tuple(a.choices) if a.choices else None) == choices, flag
        assert (action == "store_true") == (a.const is True and a.nargs == 0), flag
    assert jax_flags["--root"][1] == "/tmp/synthetic_speed"


def test_render_writes_the_index_files_main_reads(tmp_path):
    """``render_dataset`` writes ``train_s.txt`` / ``val_s.txt`` (what
    ``main`` and JAX's renderer use) equal to ``train_1.txt`` /
    ``val_1.txt`` (the configs' defaults)."""
    info = selfcheck.render_dataset(str(tmp_path), 5, seed=0, fmt="ppm")
    annos = tmp_path / "annos"
    assert info["n_train"] == 4
    for split, want in (("train", [0, 1, 2, 3]), ("val", [4])):
        ones = (annos / f"{split}_1.txt").read_text()
        assert (annos / f"{split}_s.txt").read_text() == ones
        assert np.loadtxt(annos / f"{split}_s.txt", dtype=int, ndmin=1).tolist() == want


def test_one_cpu_epoch_through_main(tmp_path):
    """``main`` renders 6 frames and fits one epoch of the small preset at 64
    on the CPU (2 train steps of batch 2, 1 val step): the best score it
    returns is finite and is the minimum ``test_score`` in its log.txt."""
    args = _args(tmp_path, "--n_images", "6", "--epochs", "1", "--batch", "2", "--resize", "64",
                 "--device", "cpu")
    best = selfcheck.main(args)
    log_txt = (tmp_path / "out" / "log.txt").read_text()
    entries = [json.loads(line) for line in log_txt.splitlines()]
    assert len(entries) == 1 and entries[0]["epoch"] == 0
    assert np.isfinite(best) and best == min(e["test_score"] for e in entries)
    assert np.isfinite(entries[0]["train_loss_total"])
    assert (tmp_path / "data" / "annos" / "train_s.txt").exists()
