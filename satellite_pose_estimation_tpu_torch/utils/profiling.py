"""Profiling and timing utilities (counterpart of utils/profiling.py).

The reference's observability is wall-clock meters only
(model_time/solver_time SmoothedValues, cuda.max_memory_allocated prints —
SURVEY.md section 5). On PyTorch:

* ``trace(logdir)`` — ``torch.profiler`` over the enclosed block (CPU
  activity, and CUDA where there is a card), written into ``logdir`` as a
  Chrome trace (TensorBoard / Perfetto);
* ``device_timer`` — wall-clock stage timing that synchronises the card
  before the block and after it;
* ``ThroughputMeter`` — the images/sec north-star meter;
* ``device_memory_stats`` — per-card memory in use and its peak.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


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


def _sync(value=None):
    """Wait for the cards: every card when ``value`` is None, else the cards
    that hold a tensor of ``value`` (a tensor or a nest of dicts, lists and
    tuples of them)."""
    if not torch.cuda.is_available():
        return
    if value is None:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        return
    stack, devices = [value], set()
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def device_timer(label: str, results: Optional[dict] = None):
    """Wall-clock a device computation accurately: the cards are synchronised
    before the block, and the devices of the holder's ``"value"`` after it."""
    _sync()
    t0 = time.perf_counter()
    holder = {}
    yield holder
    if "value" in holder:
        _sync(holder["value"])
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    print(f"[timer] {label}: {dt * 1000:.2f} ms")


class ThroughputMeter:
    """images/sec over a sliding window — the north-star metric."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.images = 0

    def update(self, n: int):
        self.images += n

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.images / dt if dt > 0 else 0.0


def device_memory_stats() -> dict:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}} for every card, {}
    without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {"bytes_in_use": torch.cuda.memory_allocated(i),
                          "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
            for i in range(torch.cuda.device_count())}
