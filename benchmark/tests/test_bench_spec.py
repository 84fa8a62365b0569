"""BENCHMARK.json against the rules the harness keeps: every name it
gives is found, names and units use the allowed characters, every per-layer
metric is reported where the end-to-end metric it moves is, the yardstick's
arithmetic on hand-worked shapes, the FLOP counts the configurations keep,
and nothing the harness or the reference imports is JAX or the JAX
package."""
import ast
import json
import re
import subprocess
import sys

import pytest

import harness
import yardstick

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_every_name_is_found():
    for cfg in SPEC["configs"]:
        assert (harness.ROOT / cfg["file"]).is_file()
        assert harness.config_spec(cfg["name"])["source"] == cfg["source"]
        harness.config_module(cfg["name"])
    for cell in SPEC["workloads"]:
        tr = harness.traffic_spec(cell["traffic"])
        assert callable(harness.driver_module(tr["driver"]).run)
        assert isinstance(harness.load_json(harness.HERE / "limits" / f"{cell['name']}.json")
                          ["limits"], dict)
    for m in SPEC["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for cell in SPEC["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_each_per_layer_metric_moves_one_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
    for cell in CELLS:
        reported = [m["name"] for m in harness.cell_metrics(SPEC, cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(SPEC, cell, "per_layer")


def test_layers_named_alike():
    for m in SPEC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_roofline_arithmetic():
    # K1 at (256, 8, 784, 32) bf16: 2 products of 2*B*H*T*T*D FLOPs,
    # 4 tensors of B*H*T*D*2 bytes and one float32 row.
    flops, nbytes = yardstick.k1_work((256, 8, 784, 32))
    assert flops == 2 * 2 * 256 * 8 * 784 * 784 * 32
    assert nbytes == 256 * 8 * 784 * (4 * 32 * 2 + 4)
    assert yardstick.bound_s(flops, nbytes, yardstick.BF16_FLOP_S) == pytest.approx(
        161.2e9 / 989e12, rel=1e-3)
    assert yardstick.bound_by(flops, nbytes, yardstick.BF16_FLOP_S) == "operations"
    # K2 at the AIFI shape (16, 8, 256, 32): bound by bytes (PERF.md: 0.0050 ms).
    flops, nbytes = yardstick.k2_work((16, 8, 256, 32))
    assert nbytes == 16 * 8 * 256 * (8 * 32 * 2 + 4)
    assert yardstick.bound_by(flops, nbytes, yardstick.BF16_FLOP_S) == "bytes"
    assert yardstick.bound_s(flops, nbytes, yardstick.BF16_FLOP_S) * 1e3 == pytest.approx(
        0.0050, abs=2e-4)
    # Two launches whose bounds are 1 ms each, run in 4 ms: 50%.
    one_ms = (989e9, 0.0)
    assert yardstick.roofline_pct([one_ms, one_ms], 4e-3) == pytest.approx(50.0)
    assert yardstick.roofline_pct([], 1.0) is None
    assert yardstick.roofline_pct([one_ms], 0.0) is None


def test_mfu_arithmetic():
    assert yardstick.mfu_pct(989e9, 100.0) == pytest.approx(10.0)


def test_metric_readers_on_a_record():
    record = {"mode": "eval", "rate": 1000.0, "flops_per_image": 98.9e9, "busy_s": 0.6,
              "window_s": 1.0, "stage_ms": {"model": 50.0, "solver": 40.0},
              "kernels_in_range": {"bench.after_model": 5569.0},
              "k1_shapes": [(256, 8, 784, 32)] * 4, "k1_s": 4e-3,
              "k2_shapes": [], "k2_s": 0.0}
    read = {m["name"]: harness.metric_reader(m["name"])(record) for m in SPEC["per_layer"]}
    assert read["mfu.eval"] == pytest.approx(10.0)
    assert read["device_idle.eval"] == pytest.approx(40.0)
    assert read["model_ms.eval"] == 50.0 and read["solver_ms.eval"] == 40.0
    assert read["solver_kernels.eval"] == 5569.0
    assert read["k1_roofline.eval"] == pytest.approx(100 * 161.2e9 / 989e12 / 1e-3, rel=1e-3)
    assert read["mfu.train"] is None and read["k2_roofline.train"] is None


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_flop_count_recounted(name):
    import torch

    import flops
    kept = harness.config_spec(name)["flops_per_image"]
    counted = flops.count(torch, name)
    assert counted["eval"] == pytest.approx(kept["eval"], rel=1e-9)
    assert counted["train"] == pytest.approx(kept["train"], rel=1e-9)


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in harness.HERE.rglob("*.py"):
        for top in _top_level_imports(path):
            assert top not in harness.FORBIDDEN, (path, top)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").rglob("*.py"):
        for top in _top_level_imports(path):
            assert top != harness.PROGRAM, (path, top)
    code = ("import sys; sys.path.insert(0, %r); "
            "import spe_ref.train.steps, spe_ref.models.detr, spe_ref.models.rtdetr, "
            "spe_ref.train.optim; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(harness.HERE / "reference"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(harness.HERE))
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(harness.FORBIDDEN)
    assert harness.PROGRAM not in loaded


def test_harness_loads_no_jax():
    """The harness with both sides' modules imported (what a run imports)
    holds no module named jax, jaxlib, flax or satellite_pose_estimation_tpu,
    compared by whole top-level names."""
    code = ("import sys; sys.path.insert(0, %r); import harness; harness.prepare_paths(); "
            "import sides, checks, tracing, report, yardstick, flops, control, run; "
            "sides.package('program'); sides.package('reference'); "
            "[harness.driver_module(d) for d in ('eval_closed_loop', 'train_steps')]; "
            "print(harness.forbidden_modules())" % str(harness.HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(harness.ROOT))
    assert out.stdout.strip().splitlines()[-1] == "[]"
