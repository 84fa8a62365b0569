"""What the program's own span recorder saw (``utils/profiling.py`` of the
port: ``span_summary()``), for the per-layer readers of ``metrics/``. The
recorder records while a ``torch.profiler`` session runs, so in a traced run
it holds the profiled steps. A program without the recorder, or a recorder
that saw no step, reads as None."""
from __future__ import annotations


def summary(profiling):
    """``profiling.span_summary()``, or None where the module has no
    recorder or the recorder saw no step."""
    read = getattr(profiling, "span_summary", None)
    if read is None:
        return None
    s = read()
    return s if s.get("steps") else None


def span_ms(profiling, name):
    """Mean ms a step of span ``name``; None where it did not run."""
    s = summary(profiling)
    if s is None or name not in s["spans"]:
        return None
    return s["spans"][name]["ms_per_step"]


def step_syncs(profiling, step):
    """Host synchronisations a step inside the outermost span ``step``: the
    syncs of every span, each put down to its innermost open span, where
    ``step`` is the span the recorder counted steps by; None otherwise."""
    s = summary(profiling)
    if s is None or step not in s["spans"] or s["spans"][step]["calls_per_step"] != 1:
        return None
    return sum(v["syncs_per_step"] for v in s["spans"].values())
