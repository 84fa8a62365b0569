"""Constants the program keeps on each device.

A constant made from host data at every call (``torch.as_tensor(array,
device=card)``) is a copy from pageable memory: the host waits there for
all the work queued before it, and a CUDA graph cannot capture it.
``device_constant`` builds each constant once per (name, device, dtype) and
hands the same tensor to every later call.
"""
from __future__ import annotations

import torch

_cache: dict = {}


def device_constant(name: str, build, device=None, dtype=None) -> torch.Tensor:
    """``torch.tensor(build(), dtype=dtype, device=device)``, made at the
    first call with this ``name``, device and dtype and returned by every
    later one (``device`` None is the CPU; ``dtype`` None keeps the data's).
    The tensor is shared: callers read it and never write to it."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (name, device, dtype)
    value = _cache.get(key)
    if value is None:
        # a normal tensor even inside inference mode, so that callers
        # outside it may save it for a backward pass
        with torch.inference_mode(False):
            value = _cache[key] = torch.tensor(build(), dtype=dtype, device=device)
    return value
