"""Profiling (counterpart of utils/profiling.py): the program's span
recorder, a trace of a block, and the cards' memory figures.

The reference's observability is wall-clock meters only
(model_time/solver_time SmoothedValues, cuda.max_memory_allocated prints —
SURVEY.md section 5). On PyTorch:

* ``span(name)`` — one named stage of the program (``eval.step``,
  ``eval.warp``, ``eval.model``, ``eval.solver``, ``solver.init``,
  ``solver.refine``, ``train.step`` and its stages, ``loss.match``; the
  keypoint and the det train steps both).
  Recording is off unless the code runs inside ``record_spans()`` or while a
  ``torch.profiler`` session runs; while it is off a span costs one check
  and does nothing else. When recording, a span opens the profiler range
  ``spe.<name>`` (so a trace shows the stages above their kernels), times
  itself by CUDA events on a card (by the host's clock elsewhere) and counts
  the host's synchronisations with the card: the outermost open span turns
  PyTorch's sync debug mode to "warn", and each "synchronizing CUDA
  operation" warning is put down to the innermost open span and to the
  program's line that made it; every other warning reaches the caller as
  it was.
* ``Stages(prefix, names, on_stage)`` — consecutive spans that end where a
  step's ``on_stage`` callback is called.
* ``span_summary()`` / ``reset_spans()`` — the recorded spans a step (a
  step is one run of the outermost span), and clearing them.
* ``count_graph(stage, kind)`` — one call of a graphed stage
  (``utils/graphs.py``) counted as an "eager" run, a "capture" or a
  "replay", for the summary's ``graphs``.
* ``record_value(name, make)`` — one reading of the counter ``name``
  (``match.fill``): ``make()`` is called only while recording and may
  return a device tensor, which stays on the device until
  ``span_summary()`` resolves it, so a reading adds no host sync.
* nothing records while the current CUDA stream is being captured into a
  graph: a span there is the null context and a stage call is not counted,
  so a capture neither breaks on an event or a sync check nor leaves
  events that never ran.
* ``trace(logdir)`` — ``torch.profiler`` over the enclosed block (CPU
  activity, and CUDA where there is a card), written into ``logdir`` as a
  Chrome trace (TensorBoard / Perfetto); spans record inside it;
* ``device_memory_stats`` — per-card memory in use and its peak.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
import warnings
from collections import Counter, defaultdict

import torch

SYNC_MESSAGE = "called a synchronizing CUDA operation"
RANGE_PREFIX = "spe."
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_NULL = contextlib.nullcontext()


class _Recorder:
    """What the spans recorded since the last ``reset``."""

    def __init__(self):
        self.forced = 0  # depth of record_spans()
        self.open = []  # the open spans, innermost last
        self.reset()

    def reset(self):
        self.pending = []  # (name, start event, end event), resolved by the summary
        self.ms = defaultdict(float)
        self.calls = {}  # name -> calls, in the order the names were first opened
        self.outer = Counter()  # name -> calls with no other span open
        self.syncs = Counter()
        self.sites = defaultdict(Counter)  # name -> {"<file>:<line>": syncs}
        self.graphs = defaultdict(Counter)  # stage -> {"eager" / "capture" / "replay": calls}
        self.values = defaultdict(list)  # counter -> readings (numbers or device tensors)


_rec = _Recorder()


def recording() -> bool:
    """Whether spans record: inside ``record_spans()`` or while a
    ``torch.profiler`` session runs."""
    return bool(_rec.forced) or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def record_spans():
    """Record spans inside the block, without a profiler session."""
    _rec.forced += 1
    try:
        yield
    finally:
        _rec.forced -= 1


def reset_spans() -> None:
    """Forget every recorded span."""
    _rec.reset()


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def count_graph(stage: str, kind: str) -> None:
    """Count one call of the graphed stage ``stage`` as ``kind`` ("eager",
    "capture" or "replay") while recording, outside a capture."""
    if recording() and not capturing():
        _rec.graphs[stage][kind] += 1


def record_value(name: str, make) -> None:
    """One reading of the counter ``name``, ``make()``, while recording and
    outside a capture; nothing is computed otherwise. A tensor reading is
    kept as it is until ``span_summary()`` resolves it."""
    if recording() and not capturing():
        _rec.values[name].append(make())


def _program_site() -> str:
    """``<file>:<line>`` of the innermost frame in the package, outside this
    module: the program's line that made a synchronisation."""
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(_PACKAGE) and path != __file__:
            return f"{path[len(_PACKAGE):]}:{frame.f_lineno}"
        frame = frame.f_back
    return "outside the package"


class _SyncCounter:
    """Sync debug mode "warn" over the outermost span, its warnings counted
    and every other warning caught there re-emitted on exit."""

    def __enter__(self):
        self.caught = []
        self.catcher = warnings.catch_warnings()
        self.catcher.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE, category=UserWarning)
        warnings.showwarning = self._show
        self.mode = None
        if torch.cuda.is_initialized():
            self.mode = torch.cuda.get_sync_debug_mode()
            if self.mode != 2:  # an "error" set by the caller stays
                torch.cuda.set_sync_debug_mode("warn")
        return self

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if issubclass(category, UserWarning) and str(message).startswith(SYNC_MESSAGE):
            if _rec.open:
                name = _rec.open[-1].name
                _rec.syncs[name] += 1
                _rec.sites[name][_program_site()] += 1
            if self.mode != 1:  # a caller's own "warn" still sees its warnings
                return
        self.caught.append((message, category, filename, lineno))

    def __exit__(self, *exc):
        try:
            if self.mode is not None:
                torch.cuda.set_sync_debug_mode(self.mode)
        finally:
            self.catcher.__exit__(*exc)
            for message, category, filename, lineno in self.caught:
                warnings.warn_explicit(message, category, filename, lineno)
        return False


class _Span:
    __slots__ = ("name", "range", "counter", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.counter = _SyncCounter().__enter__() if not _rec.open else None
        self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
        self.range.__enter__()
        _rec.open.append(self)
        _rec.calls.setdefault(self.name, 0)
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if isinstance(self.start, float):
                _rec.ms[self.name] += (time.perf_counter() - self.start) * 1e3
            else:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                _rec.pending.append((self.name, self.start, end))
            self.range.__exit__(*exc)
            _rec.open.pop()
            _rec.calls[self.name] += 1
            if not _rec.open:
                _rec.outer[self.name] += 1
        finally:
            if self.counter is not None:
                self.counter.__exit__(*exc)
        return False


def span(name: str):
    """The stage ``name`` of the program, recorded as the module's docstring
    says; a shared null context when recording is off or the current stream
    is being captured."""
    if not (_rec.forced or torch.autograd._profiler_enabled()) or capturing():
        return _NULL
    return _Span(name)


class Stages:
    """A context manager over consecutive stages ``names`` that yields
    ``end(name)``: the span ``<prefix>.<name>`` runs from the block's start
    (the first) or the previous stage's end to ``end(name)``, which then
    calls ``on_stage(name)`` if given. Stages end in the order ``names``
    gives."""

    def __init__(self, prefix: str, names, on_stage=None):
        self.prefix, self.names, self.on_stage = prefix, tuple(names), on_stage
        self.k, self.current = 0, None

    def _open(self):
        if self.k < len(self.names):
            self.current = span(f"{self.prefix}.{self.names[self.k]}")
            self.current.__enter__()

    def __enter__(self):
        self._open()
        return self.end

    def end(self, name):
        if self.k >= len(self.names) or name != self.names[self.k]:
            raise ValueError(f"stage {name!r} ended out of the order {self.names}")
        self.current.__exit__(None, None, None)
        self.current = None
        if self.on_stage is not None:
            self.on_stage(name)
        self.k += 1
        self._open()

    def __exit__(self, *exc):
        if self.current is not None:
            self.current.__exit__(*exc)
        return False


def span_summary() -> dict:
    """``{"steps": n, "spans": {name: {"ms_per_step", "calls_per_step",
    "syncs_per_step", "sync_sites"}}, "graphs": {stage: {"eager",
    "captures", "replays", "replays_per_step"}}, "counters": {name:
    {"mean", "calls", "calls_per_step"}}}`` over what was recorded since
    the last reset, after waiting for the card. A step is one run of
    the outermost span (``n`` counts the most frequent one); ``ms`` is
    device time on a card, host time elsewhere; a sync is put down to the
    innermost open span, and ``sync_sites`` gives the program's lines that
    made them (``<file in the package>:<line>``: syncs a step); ``graphs``
    counts the calls of each graphed stage by how they ran; ``counters``
    gives the mean of each counter's readings (``record_value``). Empty
    spans and no steps when nothing was recorded."""
    if _rec.pending:
        torch.cuda.synchronize()
        for name, start, end in _rec.pending:
            _rec.ms[name] += start.elapsed_time(end)
        _rec.pending = []
    for name, readings in _rec.values.items():
        _rec.values[name] = [float(v) for v in readings]
    steps = max(_rec.outer.values(), default=0)
    if not steps:
        return {"steps": 0, "spans": {}}
    return {"steps": steps, "spans": {
        name: {"ms_per_step": _rec.ms[name] / steps, "calls_per_step": calls / steps,
               "syncs_per_step": _rec.syncs[name] / steps,
               "sync_sites": {s: n / steps for s, n in _rec.sites[name].items()}}
        for name, calls in _rec.calls.items()},
        "graphs": {stage: {"eager": c["eager"], "captures": c["capture"],
                           "replays": c["replay"], "replays_per_step": c["replay"] / steps}
                   for stage, c in _rec.graphs.items()},
        "counters": {name: {"mean": sum(v) / len(v), "calls": len(v),
                            "calls_per_step": len(v) / steps}
                     for name, v in _rec.values.items() if v}}


@contextlib.contextmanager
def trace(logdir: str = "output/torch_trace"):
    """Profile the enclosed block into ``logdir`` (a
    ``<worker>.<time>.pt.trace.json`` Chrome trace); yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def device_memory_stats() -> dict:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}} for every card, {}
    without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {"bytes_in_use": torch.cuda.memory_allocated(i),
                          "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
            for i in range(torch.cuda.device_count())}
