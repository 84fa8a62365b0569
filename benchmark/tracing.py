"""A traced run's record: CUDA events around the layers of every step of
the window, and ``torch.profiler`` over a few steps after it, reduced to
aggregates (device busy time, kernel times by name, the attention kernels'
launch shapes, kernel counts by host range, the longest idle gaps by what
the host was doing). The per-layer readers in ``metrics/`` read the record.
"""
from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
K1_OP, K2_OP = "spe::fused_attention", "spe::fused_attention_bwd"
K1_KERNELS = ("attn_fwd_bf16_kernel",)
K2_KERNELS = ("attn_bwd_dq_bf16_kernel", "attn_bwd_dkv_bf16_kernel")


class Ranges:
    """Host ranges the profiler records by name (``torch.profiler`` user
    annotations), opened and closed from hooks."""

    def __init__(self, torch):
        self.torch = torch
        self.open = {}

    def begin(self, name):
        rf = self.torch.autograd.profiler.record_function(name)
        rf.__enter__()
        self.open[name] = rf

    def end(self, name):
        rf = self.open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)


def _union(intervals):
    """Merged [start, end] intervals (µs) of ``intervals``, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _trace(torch, run_step, steps: int, host: bool):
    """Chrome-trace events of ``run_step(i)`` for i < ``steps`` and the
    window's host seconds (ending in a synchronise)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=activities, record_shapes=host) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run_step(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], window_s
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile_steps(torch, run_step, steps: int, ranges=("bench.after_model",)) -> dict:
    """Profile ``steps`` calls of ``run_step(i)`` twice: with the device's
    activity alone (busy_s, window_s and the device ops by total time, where
    the profiler adds little host time), then with the host's too (the idle
    gaps by the host op that launched the work ending each gap, K1 / K2
    launch shapes and kernel seconds, and device kernels launched inside
    each named host range)."""
    events, window_s = _trace(torch, run_step, steps, host=False)
    device = reduce_trace(events, window_s, steps, ())
    events, window_s = _trace(torch, run_step, steps, host=True)
    record = reduce_trace(events, window_s, steps, ranges)
    record.update({k: device[k] for k in ("window_s", "busy_s", "device_ops")})
    return record


def reduce_trace(events, window_s: float, steps: int, ranges) -> dict:
    device, launches, cpu_ops, annotations = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat == "cpu_op":
            cpu_ops.append(e)
        elif cat == "user_annotation":
            annotations.append(e)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6

    by_name = defaultdict(float)
    for e in device:
        if e["cat"] == "kernel":
            by_name[e["name"][:96]] += e["dur"] * 1e-6
        else:
            by_name[e["cat"]] += e["dur"] * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # What the host was doing while the device waited: the innermost host
    # op around the launch of the work that ends each gap.
    cpu_ops.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in cpu_ops]

    def host_op(ts):
        hi = bisect.bisect_right(starts, ts)
        best = None
        for e in cpu_ops[max(0, hi - 400):hi]:
            if ts <= e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
                best = e
        return best["name"] if best else "host"

    first_of = {}
    for e in device:
        first_of.setdefault(e["ts"], e)
    gaps = defaultdict(float)
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        nxt = first_of.get(s1)
        corr = (nxt.get("args") or {}).get("correlation") if nxt else None
        launch = launches.get(corr)
        name = host_op(launch["ts"]) if launch else "host"
        gaps[name[:96]] += (s1 - e0) * 1e-6
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    def kernels(names):
        return sum(e["dur"] for e in device if e["cat"] == "kernel"
                   and any(n in e["name"] for n in names)) * 1e-6

    def shapes(op):
        out = []
        for e in cpu_ops:
            if e["name"] == op:
                dims = (e.get("args") or {}).get("Input Dims") or []
                if dims and dims[0]:
                    out.append(tuple(dims[0]))
        return out

    in_range = {}
    for rname in ranges:
        spans = [(a["ts"], a["ts"] + a["dur"]) for a in annotations if a["name"] == rname]
        count = 0
        for e in device:
            if e["cat"] != "kernel":
                continue
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch and any(s <= launch["ts"] <= t for s, t in spans):
                count += 1
        in_range[rname] = count / steps if spans else None

    return {
        "steps": steps, "window_s": window_s, "busy_s": busy_s,
        "device_ops": [[n, s] for n, s in device_ops],
        "idle_gaps": [[n, s] for n, s in idle_gaps],
        "k1_shapes": shapes(K1_OP), "k1_s": kernels(K1_KERNELS),
        "k2_shapes": shapes(K2_OP), "k2_s": kernels(K2_KERNELS),
        "kernels_in_range": in_range,
    }
