"""The readings that the detection train cell's output limits are set
from, at the cell's own size, several seeds in one process (``control.py``
does this for the keypoint cells; the benchmark's own runs do not run
this):

* ``program``: the program's first three det train steps against the
  reference, as a run compares them;
* ``control``: the reference computed with fp8 operands
  (``checks.fp8_control``) in the program's place, against the float32
  reference;
* faults planted in the program's steps: ``half_batch`` (each step takes
  the first half of its batch), ``rows_swapped`` (each step reads its images
  one row out of place, so that image i is trained on the targets of image
  i + 1), ``state_unchanged`` (each step leaves the parameters as it
  found them) and ``match_rolled`` (the Hungarian's assignment rolled by
  one target: a valid permutation, but not the optimum, which the
  reference follows as it follows any match);
* ``float32``: the program in float32 (TF32 off) instead of bf16, which
  shows what the compute dtype alone moves.

    python3 benchmark/det_control.py --workload <cell> --seeds 1,2,3 [--kinds program,control]

prints one JSON line per seed and kind.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import harness

KINDS = ("program", "control", "half_batch", "rows_swapped", "state_unchanged",
         "match_rolled", "float32")


def _half_batch(step):
    def train_step(state, images, labels, boxes, generator, on_stage=None):
        n = images.shape[0] // 2
        return step(state, images[:n], labels[:n], boxes[:n], generator, on_stage)
    return train_step


def _rows_swapped(step):
    def train_step(state, images, labels, boxes, generator, on_stage=None):
        return step(state, images.roll(1, 0), labels, boxes, generator, on_stage)
    return train_step


def _state_unchanged(step):
    import torch

    def train_step(state, images, labels, boxes, generator, on_stage=None):
        before = [p.detach().clone() for p in state.model.parameters()]
        out = step(state, images, labels, boxes, generator, on_stage)
        with torch.no_grad():
            for p, b in zip(state.model.parameters(), before):
                p.copy_(b)
        return out
    return train_step


def _match_rolled(hungarian):
    def solve(cost):
        return hungarian(cost).roll(1, -1)
    return solve


STEP_FAULTS = {"half_batch": _half_batch, "rows_swapped": _rows_swapped,
               "state_unchanged": _state_unchanged}
MATCH_FAULTS = {"match_rolled": _match_rolled}


@contextlib.contextmanager
def planted(det, kind: str):
    """The program's det modules ``det`` (``det_recipe.DetRecipe.det``) with
    the fault ``kind`` planted in ``make_det_train_step``'s step or in the
    criterion's ``hungarian`` (nothing for "program")."""
    if kind in STEP_FAULTS:
        module, name = det.step, "make_det_train_step"
        real = module.make_det_train_step
        fake = lambda *a, **k: STEP_FAULTS[kind](real(*a, **k))  # noqa: E731
    elif kind in MATCH_FAULTS:
        module, name = det.criterion, "hungarian"
        real = module.hungarian
        fake = MATCH_FAULTS[kind](real)
    else:
        yield
        return
    setattr(module, name, fake)
    try:
        yield
    finally:
        setattr(module, name, real)


def readings(ctx, kind: str) -> dict:
    import checks
    import det_checks
    import det_recipe
    torch, dev = ctx.torch, ctx.device
    drv = harness.driver_module("det_train_steps")
    order, pool = drv.pools(torch, ctx, dev)
    batches = drv.Batches(pool, order)
    checked = [batches.step(k) for k in range(drv.CHECKED_STEPS)]
    del pool, batches
    if kind == "control":
        side = det_recipe.DetRecipe(torch, ctx.cell["config"], "reference", ctx.config)
        watch = det_checks.watchers(side)
        with checks.float32_reference(torch), checks.fp8_control(torch):
            state, _, _, got = drv.first_steps(torch, side, ctx.seed, checked, dev, None,
                                               watch.values())
    else:
        side = det_recipe.DetRecipe(torch, ctx.cell["config"], "program", ctx.config)
        watch = det_checks.watchers(side)
        wide = kind == "float32"
        with planted(side.det, kind), (checks.float32_reference(torch) if wide
                                       else contextlib.nullcontext()):
            state, _, _, got = drv.first_steps(torch, side, ctx.seed, checked, dev,
                                               None if wide else side.compute_dtype,
                                               watch.values())
    del state
    want, gaps = drv.reference_readings(torch, ctx, checked, dev, watch)
    detail = {}
    numbers = {**checks.train_numbers(got, want, detail), **gaps}
    print(f"{kind} seed {ctx.seed}: sizes {order[:drv.CHECKED_STEPS]} losses {got['loss']} "
          f"reference {want['loss']}; worst leaves {detail}", file=sys.stderr)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--kinds", default=",".join(KINDS))
    args = p.parse_args(argv)
    harness.prepare_paths()
    import torch
    import checks
    import run
    spec = harness.benchmark_spec()
    harness.card_check(torch, harness.find_cell(spec, args.workload)["chips"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        for kind in args.kinds.split(","):
            t0 = time.perf_counter()
            ctx = run.make_context(torch, torch.device("cuda", 0), args.workload, seed, 0.0,
                                   False, t0, spec=spec)
            numbers = readings(ctx, kind)
            torch.cuda.empty_cache()
            verdict = checks.judge(numbers, ctx.limits)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers,
                              "correct": all(c["ok"] for c in verdict),
                              "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
