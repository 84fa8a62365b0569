"""CUDA graphs of the program's fixed-shape stages.

A stage whose every shape is fixed by its inputs' shapes, with no branch on
data and no host round trip (the pose solvers), is launch-bound when run
eagerly: hundreds of tiny kernels, each a few microseconds of host time.
``graphed(name, fn, *args)`` runs ``fn(*args)``, a function returning a
tuple or a dict of tensors, as the replay of a CUDA graph captured once per
key:

* the key is ``fn`` (so a function replaced or wrapped by a caller gets
  graphs of its own), the precision settings that choose its kernels (TF32
  matmuls, autocast), and each argument: a tensor by its shape, strides,
  dtype and device, anything else (None, a number) by value;
* the first call with a key runs ``fn`` eagerly; the second runs it once on
  the capture stream, captures it and replays the graph; later calls
  replay it. Before each replay the tensor arguments are copied into the
  graph's input buffers, and the outputs are copies of the graph's output
  buffers, so a result is never overwritten by a later call;
* each stage keeps the graphs of its ``LIMIT`` last-used keys (a sweep's
  last, smaller batch gets its own; older keys are dropped with their
  memory);
* arguments off the card, an input that requires grad, or a call made while
  the current stream is already being captured run ``fn`` eagerly, the
  code they ran before.

Each call counts as an eager run, a capture or a replay for the span
recorder (``utils/profiling.py``: ``span_summary()["graphs"]``).
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from . import profiling

LIMIT = 4  # graphs kept per stage

_stages: dict = {}  # stage name -> OrderedDict(key -> _Graph, or None once seen)
_streams: dict = {}  # device -> its capture stream


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "keys")

    def __init__(self, graph, inputs, outputs):
        self.graph, self.inputs = graph, inputs
        # a dict's keys, and its values as the output buffers
        self.keys = list(outputs) if isinstance(outputs, dict) else None
        self.outputs = tuple(outputs.values()) if self.keys is not None else tuple(outputs)


def _describe(arg):
    if isinstance(arg, torch.Tensor):
        return (tuple(arg.shape), arg.stride(), arg.dtype, arg.device)
    return arg


def _graphable(tensors) -> bool:
    if not tensors or tensors[0].device.type != "cuda":
        return False
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    return not profiling.capturing()


def _capture(fn, args, tensors, device) -> _Graph:
    # Input buffers are normal tensors even inside inference mode, so that a
    # replay outside it may write them.
    with torch.inference_mode(False):
        inputs = [torch.empty_like(t) for t in tensors]
    for buf, t in zip(inputs, tensors):
        buf.copy_(t)
    it = iter(inputs)
    static = [next(it) if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device), torch.no_grad():
        stream = _streams.get(device)
        if stream is None:
            stream = _streams[device] = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        # one run on the capture stream first: the libraries set up their
        # handles and workspaces for it outside the capture
        with torch.cuda.stream(stream):
            fn(*static)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            outputs = fn(*static)
        torch.cuda.current_stream(device).wait_stream(stream)
    return _Graph(graph, inputs, outputs)


def graphed(name: str, fn, *args):
    """``fn(*args)`` (a tuple or a dict of tensors), as the module's
    docstring says."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not _graphable(tensors):
        profiling.count_graph(name, "eager")
        return fn(*args)
    key = (fn, torch.backends.cuda.matmul.allow_tf32, torch.is_autocast_enabled("cuda"),
           torch.get_autocast_dtype("cuda"), tuple(_describe(a) for a in args))
    graphs = _stages.setdefault(name, OrderedDict())
    if key not in graphs:
        graphs[key] = None
        while len(graphs) > LIMIT:
            graphs.popitem(last=False)
        profiling.count_graph(name, "eager")
        return fn(*args)
    graphs.move_to_end(key)
    entry, kind = graphs[key], "replay"
    if entry is None:
        entry, kind = _capture(fn, args, tensors, tensors[0].device), "capture"
        graphs[key] = entry
    with torch.no_grad():
        for buf, t in zip(entry.inputs, tensors):
            buf.copy_(t)
        entry.graph.replay()
        out = tuple(o.clone() for o in entry.outputs)
    profiling.count_graph(name, kind)
    return dict(zip(entry.keys, out)) if entry.keys is not None else out


def clear() -> None:
    """Drop every graph (and its memory) and every seen key."""
    _stages.clear()
