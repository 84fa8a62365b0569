"""Host -> device batch prefetch (counterpart of data/prefetch.py).

The reference overlaps data loading with compute through DataLoader worker
processes. Here a producer thread copies the next ``size`` batches while the
current step runs. On a CUDA device it pins each numpy array (page-locked
host memory) and copies it with ``non_blocking=True`` on a side stream, then
records an event; the consumer makes its own (compute) stream wait on that
event before it hands the batch on, so the step is ordered after the copy
while the copy engine runs beside the step. On the CPU it is a plain
threaded queue of tensors sharing the arrays' memory.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..parallel.mesh import is_passthrough, shard_batch


def prefetch_to_device(batch_iter: Iterator[dict], size: int = 2,
                       device="cuda", mesh=None) -> Iterator[dict]:
    """Wrap a host batch iterator (dicts of numpy arrays) with device-side
    lookahead; yields dicts of tensors on ``device``. With ``mesh`` (a
    ``parallel.mesh.Mesh``) only this rank's rows of each array
    (``parallel.mesh.shard_batch``) are copied, to the mesh's device.

    Non-array entries (filenames, pad counts) pass through untouched.
    Exceptions raised on the producer thread (decode, transforms, the copy)
    re-raise at the consumer: a failed batch crashes the epoch instead of
    truncating it. If the consumer abandons the iterator (a step raised,
    KeyboardInterrupt), the producer stops instead of blocking forever on a
    full queue with device buffers held.
    """
    device = torch.device(device) if mesh is None else mesh.device
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device=device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def to_device(batch: dict):
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        if not cuda:
            return {k: v if is_passthrough(v) else torch.from_numpy(np.asarray(v))
                    for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                if is_passthrough(v):
                    out[k] = v
                else:
                    host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    out[k] = host.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        return out, event

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batch_iter:
                if stop.is_set() or not put(to_device(batch)):
                    return
        except BaseException as e:  # surface in the consumer
            put(e)
            return
        finally:
            close = getattr(batch_iter, "close", None)
            if close is not None:  # stop a generator's own producer too
                close()
        put(end)

    threading.Thread(target=worker, name="prefetch_to_device", daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        # the copy stream allocated it; the step's stream uses it
                        v.record_stream(compute)
            yield batch
    finally:
        stop.set()
