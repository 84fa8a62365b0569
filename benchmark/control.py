"""The readings that a cell's output limits are set from, at the cell's own
size, several seeds in one process (the benchmark's own runs do not run
this):

* ``program``: the program's timed path (its eval step on the check's
  batches, or its first three train steps) against the reference, as a run
  compares them;
* ``control``: the reference computed with fp8 operands
  (``checks.fp8_control``) in the program's place, against the float32
  reference;
* faults planted in the program: ``half_batch`` (eval: the model computes
  the first half of each batch and leaves the rest out, zeros; train: the steps take
  half of each batch, the mean over the rest), ``rows_swapped`` (eval: the
  model reads the batch's images one row out of place, so each image gets
  its neighbour's answers) and ``answer_altered`` (eval:
  each pose the solver produces turned by about 0.1 rad and its distance
  stretched by 2%, each SPEED score raised by 0.01). A train state left unchanged reads 1 on ``change_gap``
  by definition and needs no run.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--kinds program,control]

prints one JSON line per seed and kind.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import harness

KINDS = ("program", "control", "half_batch", "rows_swapped", "answer_altered")


def _zero_fill(torch, tree, n):
    """Outputs for a batch of ``n`` from those of its first half: the rows
    left out hold zeros, as a buffer the model never wrote."""
    if isinstance(tree, dict):
        return {k: _zero_fill(torch, v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zero_fill(torch, v, n) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return torch.cat([tree, tree.new_zeros((n - tree.shape[0], *tree.shape[1:]))])
    return tree


@contextlib.contextmanager
def half_batch_model(torch, model):
    """The model computes the first half of each batch and leaves the rest
    out (zeros)."""
    real = model.forward

    def forward(images, *args, **kwargs):
        n = images.shape[0]
        return _zero_fill(torch, real(images[: (n + 1) // 2], *args, **kwargs), n)

    model.forward = forward
    try:
        yield
    finally:
        model.forward = real


@contextlib.contextmanager
def rows_swapped_model(torch, model):
    """The model reads each batch's images one row out of place (image i
    gets the answers of image i - 1)."""
    real = model.forward

    def forward(images, *args, **kwargs):
        return real(images.roll(1, 0), *args, **kwargs)

    model.forward = forward
    try:
        yield
    finally:
        model.forward = real


@contextlib.contextmanager
def altered_answers(torch, steps_module):
    names = ("solve_pose_simple", "solve_pose_sigma", "solve_pose_self_assessed")
    real = {n: getattr(steps_module, n) for n in names}
    real_score = steps_module.speed_score_batch

    def score(*args):
        out = dict(real_score(*args))
        out["score"] = out["score"] + 0.01
        return out

    def wrap(fn):
        def solver(*args, **kwargs):
            quat, tvec, valid = fn(*args, **kwargs)
            turn = torch.tensor([0.0, 0.05, 0.0, 0.0], device=quat.device, dtype=quat.dtype)
            quat = quat + turn * torch.where(quat[..., :1] < 0, -1.0, 1.0)
            return quat / quat.norm(dim=-1, keepdim=True), tvec * 1.02, valid
        return solver

    for n, fn in real.items():
        setattr(steps_module, n, wrap(fn))
    steps_module.speed_score_batch = score
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(steps_module, n, fn)
        steps_module.speed_score_batch = real_score


def eval_readings(ctx, kind: str) -> dict:
    import checks
    import sides
    torch, dev, tr = ctx.torch, ctx.device, ctx.traffic
    drv = harness.driver_module("eval_closed_loop")
    prog = sides.Recipe(torch, ctx.cell["config"], "program", ctx.config)
    pool = prog.pool(ctx.seed, tr["check_batches"], tr["batch"], dev, tr.get("image"))
    if kind == "control":
        return drv.compare(torch, ctx, [(b, None) for b in pool], dev,
                           control=lambda: checks.fp8_control(torch))
    model, _ = prog.model(ctx.seed, dev, train=False)
    step = prog.eval_step(prog.compute_dtype)
    with contextlib.ExitStack() as stack:
        if kind == "half_batch":
            stack.enter_context(half_batch_model(torch, model))
        if kind == "rows_swapped":
            stack.enter_context(rows_swapped_model(torch, model))
        if kind == "answer_altered":
            stack.enter_context(altered_answers(torch, prog.pkg.steps))
        checked = [(b, {k: v for k, v in step(model, b).items() if k in drv.KEEP})
                   for b in pool]
        selections = drv.program_selections(torch, prog, model, step, checked)
    del model, step
    return drv.compare(torch, ctx, checked, dev, selections)


def train_readings(ctx, kind: str) -> dict:
    import checks
    import sides
    torch, dev, tr = ctx.torch, ctx.device, ctx.traffic
    drv = harness.driver_module("train_steps")
    B = tr["batch"]
    prog = sides.Recipe(torch, ctx.cell["config"], "program", ctx.config)
    batches = prog.pool(ctx.seed, drv.CHECKED_STEPS, B, dev, tr.get("image"))
    if kind == "control":
        ref = sides.Recipe(torch, ctx.cell["config"], "reference", ctx.config)
        watch = checks.watchers(torch, ref)
        with checks.float32_reference(torch), checks.fp8_control(torch):
            state, _, _, got = drv.first_steps(torch, ref, ctx.seed, batches, dev, None,
                                               watch.values())
    elif kind == "program" or kind == "half_batch":
        watch = checks.watchers(torch, prog)
        feed = batches if kind == "program" else [{k: v[: B // 2] for k, v in b.items()}
                                                  for b in batches]
        state, _, _, got = drv.first_steps(torch, prog, ctx.seed, feed, dev,
                                           prog.compute_dtype,
                                           watch.values())
    else:
        return {}
    del state
    want, gaps = drv.reference_readings(torch, ctx, batches, dev, watch)
    detail = {}
    numbers = {**checks.train_numbers(got, want, detail), **gaps}
    print(f"{kind} seed {ctx.seed}: losses {got['loss']} reference {want['loss']}; worst leaves "
          f"{detail}", file=sys.stderr)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--kinds", default=",".join(KINDS))
    args = p.parse_args(argv)
    harness.prepare_paths()
    import torch
    import run
    spec = harness.benchmark_spec()
    harness.card_check(torch, harness.find_cell(spec, args.workload)["chips"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        for kind in args.kinds.split(","):
            t0 = time.perf_counter()
            ctx = run.make_context(torch, torch.device("cuda", 0), args.workload, seed, 0.0,
                                   False, t0, spec=spec)
            fn = eval_readings if ctx.traffic["driver"] == "eval_closed_loop" else train_readings
            numbers = fn(ctx, kind)
            torch.cuda.empty_cache()
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers,
                              "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
