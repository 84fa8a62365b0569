"""Detection training steps: the program's ``make_det_train_step`` (the
step ``DetSolver`` runs) with the recipe's optimizer groups, schedule, clip,
EMA and CDN, back to back over a pool of distinct device-resident batches
of each published multi-scale size, the sizes taken in an order shuffled
from the seed pass after pass (``det_inputs.size_order``), the losses read
back every 10th step.

Set-up builds the train state, runs its first three steps (the steps the
output check compares with the reference), then one step at every size
those did not take, so that the window meets no shape for the first time.
End-to-end: ``train_img_per_s``, all images of all steps over the window's
whole time. Traced runs: CUDA events at the step's ``on_stage`` callback
give the forward, loss (the match included), backward and optimizer
spans; the profiler over ``profile_steps`` steps at the configuration's
input size gives the rest, and the device kernels launched inside the
program's range ``spe.loss.match``.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import checks
import det_checks
import det_inputs
import det_recipe
import harness
import inputs
import report
import tracing

STAGES = ("forward", "loss", "backward", "optimizer")
CHECKED_STEPS = 3
READ_EVERY = 10
MATCH_RANGE = "spe.loss.match"


class Batches:
    """The batches of a run in the order its steps take them: step k at
    size ``order[k % len(order)]``, each size cycling through its own
    pool."""

    def __init__(self, pools: dict, order):
        self.pools, self.order = pools, list(order)
        self.taken = dict.fromkeys(pools, 0)

    def of_size(self, size):
        pool = self.pools[size]
        b = pool[self.taken[size] % len(pool)]
        self.taken[size] += 1
        return b

    def step(self, k):
        return self.of_size(self.order[k % len(self.order)])


def first_steps(torch, recipe, seed, batches, device, compute_dtype, watch=()):
    """Build ``recipe``'s model and train state from ``seed`` and run its
    first steps on ``batches`` with the context managers ``watch`` active;
    returns (state, step, generator, readings)."""
    model, shapes = recipe.model(seed, device, train=True)
    state, tcfg = recipe.train_state(model, batches[0]["images"].shape[0])
    step = recipe.train_step(tcfg, compute_dtype)
    gen = torch.Generator(device=device).manual_seed(inputs.derive(seed, inputs.AUGMENT))
    losses, grads = [], None
    with contextlib.ExitStack() as stack:
        for w in watch:
            stack.enter_context(w)
        for k, b in enumerate(batches):
            losses.append(step(state, b["images"], b["labels"], b["boxes"], gen)["loss_total"])
            if k == 0:
                grads = checks.first_gradient_norms(torch, state.optimizer)
    readings = checks.train_readings(torch, state.model, grads, losses, shapes, seed, device,
                                     recipe.scaled)
    return state, step, gen, readings


def pools(torch, ctx, device):
    """(size order, {size: pool}) of the run's seed."""
    cfg, tr = ctx.config, ctx.traffic
    order = det_inputs.size_order(ctx.seed, cfg["multi_scale"])
    return order, det_inputs.batch_pools(torch, ctx.seed, order, tr["pool"], tr["batch"],
                                         cfg["max_targets"], tr["targets"], tr["image"], device)


def run(ctx):
    torch, dev, tr = ctx.torch, ctx.device, ctx.traffic
    B = tr["batch"]
    prog = det_recipe.DetRecipe(torch, ctx.cell["config"], "program", ctx.config)
    order, pool = pools(torch, ctx, dev)
    batches = Batches(pool, order)
    harness.sync(torch, dev)
    ctx.mark("pool")
    checked = [batches.step(k) for k in range(CHECKED_STEPS)]
    watch = det_checks.watchers(prog)
    state, step, gen, got = first_steps(torch, prog, ctx.seed, checked, dev,
                                        prog.compute_dtype, watch.values())
    harness.sync(torch, dev)
    ctx.mark("first_steps")
    for size in pool:
        if size not in order[:CHECKED_STEPS]:
            b = batches.of_size(size)
            step(state, b["images"], b["labels"], b["boxes"], gen)
    harness.sync(torch, dev)
    ctx.mark("warmup")
    setup_s = time.perf_counter() - ctx.t_start

    events = []
    mark = None
    k = CHECKED_STEPS
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    i = 0
    host = [(t0, time.process_time())]  # the host's clock and its CPU time at each step's end
    while True:
        b = batches.step(k)
        k += 1
        if ctx.trace:
            cur = [_event(torch)]
            events.append(cur)
            mark = (lambda name, cur=cur: cur.append(_event(torch)) if name in STAGES else None)
        out = step(state, b["images"], b["labels"], b["boxes"], gen, on_stage=mark)
        i += 1
        if i % READ_EVERY == 0:
            out["loss_total"].item()
        host.append((time.perf_counter(), time.process_time()))
        if host[-1][0] >= deadline:
            break
    harness.sync(torch, dev)
    window_s = time.perf_counter() - t0
    rate = B * i / window_s

    record = None
    if ctx.trace:
        spans = {s: statistics.mean(e[n].elapsed_time(e[n + 1]) for e in events)
                 for n, s in enumerate(STAGES)}
        record = {"mode": "train", "batch": B, "rate": rate,
                  "flops_per_image": ctx.config["flops_per_image"]["train"],
                  "stage_ms": spans}
        def one(_):
            # the input size: the AIFI's T = 400 takes K1 / K2, which the
            # encoder leaves to its plain core under 256 tokens (size 480)
            b = batches.of_size(ctx.config["input_size"])
            step(state, b["images"], b["labels"], b["boxes"], gen)

        record.update(tracing.profile_steps(torch, one, tr["profile_steps"],
                                            ranges=(MATCH_RANGE,)))
    peak = harness.peak_bytes(torch, dev)
    del state, step, out, pool, batches, events
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want, gaps = reference_readings(torch, ctx, checked, dev, watch)
    numbers = {**checks.train_numbers(got, want), **gaps}
    verdict = checks.judge(numbers, ctx.limits)
    metrics = {"train_img_per_s": (rate, "img/s"), "setup_s": (setup_s, "s")}
    result = report.result(ctx, metrics, record, verdict, attempted=i * B, peak=peak,
                           extra={"unjudged": {n: v for n, v in numbers.items()
                                               if n not in ctx.limits},
                                  "steps": i, "losses": got["loss"], "sizes": order,
                                  "step_s": _steps(host, 0), "step_cpu_s": _steps(host, 1)})
    return result, verdict


def _steps(host, field: int) -> list:
    """Each window step's share of ``host``'s clock (0) or CPU time (1)."""
    return [round(end[field] - start[field], 4) for start, end in zip(host, host[1:])]


def _event(torch):
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def reference_readings(torch, ctx, batches, device, watch, control=None):
    """The reference's readings over a side's first steps in float32 (TF32
    off), replaying that side's CDN draws and following its query
    selections and matches (``watch``, from ``det_checks.watchers``), and
    how far the followed choices of the first step lie from the reference's
    own (``selection_gap``, ``match_gap``), and how far the side's own
    matches lie from the optimum of its own costs (``match_opt_gap``);
    ``control``, a context manager, computes the reference under it instead
    (the lower-precision control)."""
    ref = det_recipe.DetRecipe(torch, ctx.cell["config"], "reference", ctx.config)
    follow = det_checks.followers(ref, watch)
    extra = [control()] if control is not None else []
    with checks.float32_reference(torch):
        state, _, _, readings = first_steps(torch, ref, ctx.seed, batches, device, None,
                                            [*follow.values(), *extra])
    del state
    return readings, {"selection_gap": follow["topk"].gaps[0],
                      "match_gap": follow["match"].gaps[0],
                      "match_opt_gap": det_checks.optimum_gap(watch["match"])}
