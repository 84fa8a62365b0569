"""Training steps: the program's ``make_train_step`` with the recipe's
optimizer groups, schedule, clip and EMA, over a pool of distinct
device-resident batches, cycled, the losses read back every 10th step (as
``SpeedSolver`` logs them).

Set-up builds the train state, drives it through its first three steps on
three distinct batches (the steps the output check compares with the
reference; they also warm up every kernel and plan), and hands that same
state to the window. End-to-end: ``train_img_per_s``, all images of all
steps over the window's whole time. Traced runs: CUDA events from the
step's ``on_stage`` callback give the augment, forward, loss, backward and
optimizer spans; the profiler over a few steps gives the rest.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import checks
import harness
import inputs
import report
import sides
import tracing

STAGES = ("augment", "forward", "loss", "backward", "optimizer")
CHECKED_STEPS = 3
READ_EVERY = 10



def first_steps(torch, recipe, seed, batches, device, compute_dtype, watch=()):
    """Build ``recipe``'s model and train state from ``seed`` and run the
    first steps on ``batches`` with the context managers ``watch`` active;
    returns (state, step, generator, readings)."""
    model, shapes = recipe.model(seed, device, train=True)
    state, tcfg = recipe.train_state(model, batches[0]["image"].shape[0])
    step = recipe.train_step(tcfg, compute_dtype)
    gen = torch.Generator(device=device).manual_seed(inputs.derive(seed, inputs.AUGMENT))
    if device.type == "cuda":
        torch.cuda.manual_seed(inputs.derive(seed, inputs.DROPOUT))
    losses, grads = [], None
    with contextlib.ExitStack() as stack:
        for w in watch:
            stack.enter_context(w)
        for k, b in enumerate(batches):
            losses.append(step(state, b, gen)["loss_total"])
            if k == 0:
                grads = checks.first_gradient_norms(torch, state.optimizer)
    readings = checks.train_readings(torch, state.model, grads, losses, shapes, seed, device,
                                     recipe.scaled)
    return state, step, gen, readings


def run(ctx):
    torch, dev, tr = ctx.torch, ctx.device, ctx.traffic
    B = tr["batch"]
    prog = sides.Recipe(torch, ctx.cell["config"], "program", ctx.config)
    pool = prog.pool(ctx.seed, tr["pool"], B, dev, tr.get("image"))
    harness.sync(torch, dev)
    ctx.mark("pool")
    watch = checks.watchers(torch, prog)
    state, step, gen, got = first_steps(torch, prog, ctx.seed, pool[:CHECKED_STEPS], dev,
                                        prog.compute_dtype,
                                        watch.values())
    harness.sync(torch, dev)
    ctx.mark("first_steps")
    setup_s = time.perf_counter() - ctx.t_start

    events = []
    mark = None
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    i = 0
    while True:
        b = pool[(CHECKED_STEPS + i) % len(pool)]
        if ctx.trace:
            cur = [_event(torch)]
            events.append(cur)
            mark = (lambda name, cur=cur: cur.append(_event(torch)))
        out = step(state, b, gen, on_stage=mark)
        i += 1
        if i % READ_EVERY == 0:
            out["loss_total"].item()
            if time.perf_counter() >= deadline:
                break
    harness.sync(torch, dev)
    window_s = time.perf_counter() - t0
    rate = B * i / window_s

    record = None
    if ctx.trace:
        harness.sync(torch, dev)
        spans = {s: statistics.mean(e[k].elapsed_time(e[k + 1]) for e in events)
                 for k, s in enumerate(STAGES)}
        record = {"mode": "train", "batch": B, "rate": rate,
                  "flops_per_image": ctx.config["flops_per_image"]["train"],
                  "stage_ms": spans}

        def one(k):
            step(state, pool[k % len(pool)], gen)

        record.update(tracing.profile_steps(torch, one, tr["profile_steps"], ranges=()))
    peak = harness.peak_bytes(torch, dev)
    checked = pool[:CHECKED_STEPS]
    del state, step, out, pool, events
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want, gaps = reference_readings(torch, ctx, checked, dev, watch)
    numbers = {**checks.train_numbers(got, want), **gaps}
    verdict = checks.judge(numbers, ctx.limits)
    metrics = {"train_img_per_s": (rate, "img/s"), "setup_s": (setup_s, "s")}
    result = report.result(ctx, metrics, record, verdict, attempted=i * B, peak=peak,
                           extra={"unjudged": {k: v for k, v in numbers.items() if k not in ctx.limits},
                                  "steps": i, "losses": got["loss"]})
    return result, verdict


def _event(torch):
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def reference_readings(torch, ctx, batches, device, watch, control=None):
    """The reference's readings over a side's first steps, in float32 (TF32
    off), replaying that side's dropout masks and following its query
    selections and matches (``watch``, from ``checks.watchers``), and how far
    the followed choices of the first step lie from the reference's own
    (``selection_gap``, ``match_gap``); ``control``, a context manager,
    computes the reference under it instead (the lower-precision control).
    The steps after the first start from parameters that already differ, so
    only the first step's choices are judged."""
    ref = sides.Recipe(torch, ctx.cell["config"], "reference", ctx.config)
    follow = checks.followers(torch, ref, watch, device)
    extra = [control()] if control is not None else []
    with checks.float32_reference(torch):
        state, _, _, readings = first_steps(torch, ref, ctx.seed, batches, device, None,
                                            [*follow.values(), *extra])
    del state
    gaps = {}
    if "topk" in follow:
        gaps["selection_gap"] = follow["topk"].gaps[0]
    if "match" in follow:
        gaps["match_gap"] = follow["match"].gaps[0]
    return readings, gaps
