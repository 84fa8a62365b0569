"""Eval sweep, closed loop, one batch in flight: the program's
``make_eval_step`` over a pool of distinct device-resident batches, cycled,
each batch's poses read back to the host (as a submission writes its CSV)
before the next is sent.

End-to-end: ``eval_img_per_s`` (all images whose poses reached the host,
over the window's whole time) and ``eval_p90_ms`` (90th percentile over
every batch of the window, from the call into the step until quat_pr,
tvec_pr and valid are on the host). Traced runs: CUDA events from forward
hooks on the model give the model span and the span from the model's end to
the step's end (softmax, de-normalisation, solver, score, read-back); the
profiler over a few steps gives the rest of the record.
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

READ_BACK = ("quat_pr", "tvec_pr", "valid")
KEEP = ("quat_pr", "tvec_pr", "valid", "points", "probs", "sigmas", "score")



def quantile(values, q):
    """The ``q`` quantile of ``values`` (linear between order statistics)."""
    s = sorted(values)
    pos = (len(s) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def run(ctx):
    torch, dev, tr = ctx.torch, ctx.device, ctx.traffic
    B = tr["batch"]
    prog = sides.Recipe(torch, ctx.cell["config"], "program", ctx.config)
    model, _ = prog.model(ctx.seed, dev, train=False)
    step = prog.eval_step(prog.compute_dtype)
    pool = prog.pool(ctx.seed, tr["pool"], B, dev, tr.get("image"))
    harness.sync(torch, dev)
    ctx.mark("weights_and_pool")

    hooks = Hooks(torch, model) if ctx.trace else None
    for b in pool[:tr["warmup"]]:
        out = step(model, b)
        [out[k].cpu() for k in READ_BACK]
    harness.sync(torch, dev)
    ctx.mark("warmup")
    setup_s = time.perf_counter() - ctx.t_start

    # The answers the output check compares: a sample of the window's
    # batches drawn from the seed among its first cycles (a window runs at
    # least those), kept on the device until the window has closed.
    gen = torch.Generator().manual_seed(inputs.derive(ctx.seed, inputs.SAMPLE))
    span = tr["sample_span"] * len(pool)
    picks = set(torch.randperm(span, generator=gen)[:tr["check_batches"]].tolist())
    lat, kept = [], []
    if hooks:
        hooks.on = True
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    i = 0
    while True:
        b = pool[i % len(pool)]
        ts = time.perf_counter()
        if hooks:
            hooks.step_begin()
        out = step(model, b)
        [out[k].cpu() for k in READ_BACK]
        if hooks:
            hooks.step_end()
        te = time.perf_counter()
        lat.append(te - ts)
        if i in picks:
            kept.append((pool[i % len(pool)], {k: out[k] for k in KEEP}))
        i += 1
        if te >= deadline and i >= span:
            break
    window_s = time.perf_counter() - t0
    rate = B * i / window_s

    record = None
    if ctx.trace:
        hooks.on = False
        record = {"mode": "eval", "batch": B, "rate": rate,
                  "flops_per_image": ctx.config["flops_per_image"]["eval"],
                  "stage_ms": hooks.stage_ms()}

        def one(k):
            hooks.step_begin(events=False)
            o = step(model, pool[k % len(pool)])
            [o[key].cpu() for key in READ_BACK]
            hooks.step_end(events=False)

        hooks.on = True
        record.update(tracing.profile_steps(torch, one, tr["profile_steps"]))
        hooks.remove()
    peak = harness.peak_bytes(torch, dev)

    checked = kept
    selections = program_selections(torch, prog, model, step, checked)
    del model, step, out, hooks
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(torch, ctx, checked, dev, selections)
    verdict = checks.judge(numbers, ctx.limits)

    metrics = {"eval_img_per_s": (rate, "img/s"),
               "eval_p90_ms": (quantile(lat, 0.9) * 1e3, "ms"),
               "setup_s": (setup_s, "s")}
    result = report.result(ctx, metrics, record, verdict, attempted=i * B,
                           peak=peak, extra={"unjudged": {k: v for k, v in numbers.items() if k not in ctx.limits},
                                  "batches": i, "eval_p50_ms":
                                             statistics.median(lat) * 1e3})
    return result, verdict


def reference_outputs(torch, ref, model, batch, sigma: bool):
    """The reference model's probabilities, points and (sigma solvers)
    sigmas for ``batch``, as the eval step derives them from the model."""
    size = ref.spec["input_size"]
    imgs = ref.pkg.image_warp.crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"],
                                                    size, True)
    outs = model(imgs)
    clip = batch["clip_bbox"].float()
    wh = clip[:, 2:4] - clip[:, 0:2]
    got = {"probs": torch.softmax(outs["pred_logits"], dim=-1),
           "points": outs["pred_points"] * wh[:, None, :] + clip[:, None, 0:2]}
    if sigma:
        got["sigmas"] = torch.exp(outs["pred_sigmas"]) * wh[:, None, :] ** 2
    return got


def reference_solve(torch, ref, out, batch):
    """The reference solver and score on a side's points, probabilities
    and sigmas."""
    world = ref.world.to(out["points"].device)
    cfg = ref.pkg.solvers.SolverConfig(input_size=ref.spec["input_size"])
    if ref.spec["solver"] == "simple":
        quat, tvec, valid = ref.pkg.solvers.solve_pose_simple(world, out["points"], out["probs"],
                                                               cfg)
    else:
        quat, tvec, valid = ref.pkg.solvers.solve_pose_sigma(world, out["points"], out["probs"],
                                                              out["sigmas"], cfg)
    return {"quat": quat, "tvec": tvec, "valid": valid}


def side_view(batch, out, sigma: bool) -> dict:
    return {"clip": batch["clip_bbox"].float(), "points": out["points"], "probs": out["probs"],
            "sigmas": out["sigmas"], "sigmas_used": sigma, "quat": out["quat_pr"],
            "tvec": out["tvec_pr"], "valid": out["valid"], "score": out["score"]}


def program_selections(torch, prog, model, step, checked):
    """The decoder's query picks for each checked batch, from the program's
    step run again on it after the window (None for a model that selects
    no queries)."""
    if prog.selector is None:
        return None
    out = []
    for batch, _ in checked:
        with checks.Recorder(prog.selector, "topk") as rec:
            step(model, batch)
        out.append(rec.picks)
    return out


def compare(torch, ctx, checked, dev, selections=None, control=None):
    """The eval numbers of the kept outputs ``checked`` ([(batch,
    outputs)]) against the reference, widest over all sampled images; with
    ``selections`` the reference follows the program's query picks, and
    ``selection_gap`` says how far they fall below its own. ``control``, a
    context manager, computes the reference under it and compares that (the
    lower-precision control) in the program's place."""
    ref = sides.Recipe(torch, ctx.cell["config"], "reference", ctx.config)
    sigma = ctx.config["solver"] != "simple"
    model, _ = ref.model(ctx.seed, dev, train=False)
    per, gap = [], None
    with torch.inference_mode(), checks.float32_reference(torch):
        for n, (batch, out) in enumerate(checked):
            picks = selections[n] if selections is not None else None
            if control is not None:
                with contextlib.ExitStack() as stack:
                    stack.enter_context(control())
                    if ref.selector is not None:
                        rec = stack.enter_context(checks.Recorder(ref.selector, "topk"))
                    out = reference_outputs(torch, ref, model, batch, sigma)
                picks = rec.picks if ref.selector is not None else None
                out.setdefault("sigmas", torch.ones_like(out["points"]))
                solved = reference_solve(torch, ref, out, batch)
                out.update(quat_pr=solved["quat"], tvec_pr=solved["tvec"], valid=solved["valid"],
                           score=ref.pkg.scoring.speed_score_batch(
                               solved["quat"], solved["tvec"], batch["quat_gt"],
                               batch["tvec_gt"])["score"])
            with contextlib.ExitStack() as stack:
                if picks is not None:
                    follow = stack.enter_context(checks.FollowTopk(ref.selector, picks))
                want = reference_outputs(torch, ref, model, batch, sigma)
            if picks is not None:
                gap = max([gap or 0.0, *follow.gaps])
            solved = reference_solve(torch, ref, out, batch)
            score = ref.pkg.scoring.speed_score_batch(out["quat_pr"], out["tvec_pr"],
                                                      batch["quat_gt"], batch["tvec_gt"])["score"]
            want.setdefault("sigmas", torch.ones_like(want["points"]))
            per.append(checks.eval_numbers(torch, side_view(batch, out, sigma), want, solved,
                                           score))
    numbers = checks.over_batches(per)
    if gap is not None:
        numbers["selection_gap"] = gap
    return numbers


class Hooks:
    """CUDA events at each step's start, at the model's start and end
    (forward pre- and post-hooks registered on the model) and at the step's
    end; the profiler range ``bench.after_model`` from the model's end to
    the step's end."""

    def __init__(self, torch, model):
        self.torch = torch
        self.on = False
        self.events = []  # (step start, model start, model end, step end)
        self.cur = None
        self.ranges = tracing.Ranges(torch)
        self.handles = [model.register_forward_pre_hook(self._pre),
                        model.register_forward_hook(self._post)]

    def _event(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def step_begin(self, events=True):
        self.cur = [self._event()] if events else None

    def _pre(self, module, args):
        if self.on and self.cur is not None:
            self.cur.append(self._event())

    def _post(self, module, args, output):
        if self.on:
            if self.cur is not None:
                self.cur.append(self._event())
            self.ranges.begin("bench.after_model")

    def step_end(self, events=True):
        self.ranges.end("bench.after_model")
        if events and self.cur is not None and len(self.cur) == 3:
            self.cur.append(self._event())
            self.events.append(self.cur)
        self.cur = None

    def stage_ms(self):
        self.torch.cuda.synchronize()
        model = [m0.elapsed_time(m1) for _, m0, m1, _ in self.events]
        after = [m1.elapsed_time(e) for _, _, m1, e in self.events]
        return {"model": statistics.mean(model) if model else None,
                "solver": statistics.mean(after) if after else None}

    def remove(self):
        for h in self.handles:
            h.remove()
