"""Benchmark of satellite_pose_estimation_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: it builds
the cell's configuration with weights and inputs made on the card from the
seed, warms up its shapes (set-up), measures for ``--seconds``, checks what
the timed path produced against the plain reference, and prints one JSON
line: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics and the device's busy time. It refuses to run without
a card, and prints no result if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import sys  # noqa: E402

import harness  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a driver needs to run one cell."""
    torch: object
    device: object
    cell: dict
    spec: dict  # BENCHMARK.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json
    seed: int
    seconds: float
    trace: bool
    t_start: float
    marks: dict = dataclasses.field(default_factory=dict)  # set-up stage -> s since start

    def mark(self, stage: str) -> None:
        """Record that set-up reached the end of ``stage``."""
        self.marks[stage] = time.perf_counter() - self.t_start


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_context(torch, device, cell_name: str, seed: int, seconds: float, trace: bool,
                 t_start: float, spec=None, config=None) -> Context:
    import checks
    spec = spec or harness.benchmark_spec()
    cell = harness.find_cell(spec, cell_name)
    return Context(torch=torch, device=device, cell=cell, spec=spec,
                   config=config or harness.config_spec(cell["config"]),
                   traffic=harness.traffic_spec(cell["traffic"]),
                   limits=checks.limits(cell_name), seed=seed, seconds=seconds,
                   trace=trace, t_start=t_start)


def main(argv=None) -> int:
    args = parse_args(argv)
    harness.prepare_paths()
    spec = harness.benchmark_spec()
    cell = harness.find_cell(spec, args.workload)
    import torch
    harness.card_check(torch, cell["chips"])
    print(f"card: {harness.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    ctx = make_context(torch, torch.device("cuda", 0), args.workload, args.seed, args.seconds,
                       bool(args.trace), T_START, spec=spec)
    ctx.mark("import")
    driver = harness.driver_module(ctx.traffic["driver"])
    result, checks_out = driver.run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(result, checks_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
