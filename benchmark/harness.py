"""What every cell of the benchmark shares: finding a cell, its
configuration, its traffic, its driver and its per-layer metrics by the
names ``BENCHMARK.json`` gives them; the card check; the result line; the
check that nothing of JAX was loaded.

A cell names a configuration and a traffic mix. ``configs/<config>.json``
holds the configuration's sizes and ``configs/<config>.py`` builds it on
either side (the program or the plain reference, ``reference/spe_ref``);
``traffic/<traffic>.json`` names its driver (``drivers/<driver>.py``) and
that driver's parameters; ``metrics/<metric>.py`` reads one per-layer metric
from a traced run's record. A later cell or metric adds files and edits
none.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "satellite_pose_estimation_tpu_torch"
# Top-level module names that no run may hold once its window has closed:
# JAX, its libraries and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "satellite_pose_estimation_tpu")


def prepare_paths() -> None:
    """The checkout's root (the program) and the reference's folder on
    ``sys.path``; every build and kernel cache at a fixed path inside the
    checkout."""
    for p in (str(ROOT), str(HERE / "reference")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str):
    """Import the file ``path`` as module ``name`` (file names may hold dots)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def config_spec(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def config_module(name: str):
    return load_module(HERE / "configs" / f"{name}.py", f"bench_config_{name}")


def traffic_spec(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def driver_module(name: str):
    return load_module(HERE / "drivers" / f"{name}.py", f"bench_driver_{name}")


def metric_reader(name: str):
    """``read(record) -> number or None`` of the per-layer metric ``name``."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")).read


def cell_metrics(spec: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``cell`` reports:
    those that list it under ``workloads`` and those with no such list."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the program's name begins with the JAX package's)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_check(torch, chips: int) -> None:
    """Exit non-zero, printing no result, without ``chips`` CUDA devices."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the card and runs nowhere else")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible")


def sync(torch, device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU,
    where the output checks' tests drive a run)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(torch, device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def device_name(torch, device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def emit(result: dict, checks: list) -> None:
    """Print the compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output, its
    ``checks`` key last."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    line = dict(result)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
