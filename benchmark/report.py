"""The result line of a run: the cell's end-to-end metrics (untraced) or
per-layer metrics with the device's busy time and breakdown (traced), the
device, and the verdict of the output check."""
from __future__ import annotations

import harness


def result(ctx, measured: dict, record, verdict: list, attempted: int, peak: int,
           extra: dict | None = None) -> dict:
    torch, name = ctx.torch, ctx.cell["name"]
    device = {"platform": "gpu", "kind": harness.device_name(torch, ctx.device),
              "count": ctx.cell["chips"], "memory_peak_bytes": int(peak)}
    if ctx.trace:
        metrics = {}
        for m in harness.cell_metrics(ctx.spec, name, "per_layer"):
            value = harness.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = record["busy_s"]
        device["window_s"] = record["window_s"]
    else:
        metrics = {m["name"]: {"value": measured[m["name"]][0], "unit": m["unit"]}
                   for m in harness.cell_metrics(ctx.spec, name, "end_to_end")}
    out = {"correct": bool(verdict) and all(c["ok"] for c in verdict),
           "attempted": attempted, "failed": 0, "metrics": metrics, "device": device}
    if ctx.trace:
        out["breakdown"] = {"device_ops": record["device_ops"], "idle_gaps": record["idle_gaps"]}
    info = dict(extra or {})
    if getattr(ctx, "marks", None):
        info["setup_parts_s"] = dict(ctx.marks)
    if info:
        out["info"] = info
    return out
