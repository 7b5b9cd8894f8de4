"""A step captured once as a CUDA graph and replayed: the port's
counterpart of ``jax.jit``.

The JAX package compiles each step into one program (``api.py:129``
``@jax.jit``, ``dock_step.py:490, :712``, the Dock's stream program
``models/dock.py:773-848``), so a frame costs one dispatch.  The port's
steps issue their kernels and glue from Python, ~90-310 device operations
a frame; :class:`CapturedStep` records that sequence once per input
signature and replays it, so a frame costs a few copies and one graph
launch.

What a captured step does on a CUDA device:

* it owns static input buffers, one per argument: a tensor (a frame, a
  plane of an NV12 pair, a rect, a batch of clocks) is copied into its
  buffer device to device; a Python number (the zebra clock ``tm``) is
  written into a 0-d float32 buffer with ``fill_`` and a sequence of Python
  ints (a rect) into an int32 buffer element by element, also with
  ``fill_``, which passes each value as a kernel argument: nothing is
  copied from host memory.  A float and a 0-d float32 tensor share a
  buffer, and so do a host rect and a (4,) int32 tensor;
* on the first call with a new signature (the shapes and dtypes of the
  arguments) it runs the step twice on a side stream (the warm-up, which
  builds the kernels and every cached constant), then captures one call
  with ``torch.cuda.graph`` in thread-local mode, so that other threads
  (a pipeline driver's producer) may go on working meanwhile.  A capture
  that fails raises: there is no eager fallback;
* every call copies the arguments in, replays, and returns fresh output
  tensors, one device copy per field, so a result never changes at a later
  call (as JAX's returned arrays do not);
* it keeps at most ``max_graphs`` graphs, dropping the least recently used
  (with it, its memory pool);
* the kernel wrappers count their launches in Python, which a replay does
  not run, so each graph records the launches its capture made and every
  replay adds them.  The warm-up and the capture are set-up: the counters
  are restored after them, and they count only the replays' launches.

On the CPU the step runs as it is, uncaptured (a host rect becomes an int32
tensor first).  ``step.eager`` is the uncaptured function on any device.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from .api import check_device


def _counters() -> list:
    """(wrapper, attribute) of every kernel launch counter."""
    from .ops import decode, fused_overlays, pipeline, scope_stats

    vs = scope_stats.vs_wv_counts
    fo = fused_overlays.fused_overlays_planes
    return [(pipeline.frame_pass, "launches"), (pipeline.frame_pass, "launches_vec"),
            (vs, "launches"), (vs, "launches_vec"), (vs, "launches_vs_only"),
            (vs, "launches_wv_only"), (vs, "launches_rect"),
            (fo, "launches"), (fo, "launches_rect"), (fo, "launches_vec"),
            (decode.nv12_decode, "launches"), (decode.nv12_16_decode, "launches")]


def _read_counters(counters) -> list[int]:
    return [getattr(obj, name) for obj, name in counters]


def _is_int_seq(a) -> bool:
    return isinstance(a, (tuple, list)) and all(
        isinstance(v, int) and not isinstance(v, bool) for v in a)


def _spec(a):
    """The signature of one argument: ("t", shape, dtype) for what becomes
    one buffer, ("seq", specs) for a tuple of tensors (an NV12 pair)."""
    if isinstance(a, torch.Tensor):
        return ("t", tuple(a.shape), a.dtype)
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return ("t", (), torch.float32)
    if _is_int_seq(a):
        return ("t", (len(a),), torch.int32)
    if isinstance(a, (tuple, list)) and all(isinstance(x, torch.Tensor) for x in a):
        return ("seq", tuple(_spec(x) for x in a))
    raise TypeError(f"a captured step takes tensors, numbers and int sequences, got {type(a)}")


def _buffer(spec, device):
    if spec[0] == "seq":
        return tuple(_buffer(s, device) for s in spec[1])
    return torch.empty(spec[1], dtype=spec[2], device=device)


def _fill(buf, a, device) -> None:
    """Write one argument into its buffer, on the current stream."""
    if isinstance(a, torch.Tensor):
        check_device(a, device)
        buf.copy_(a)
    elif isinstance(a, (int, float)):
        buf.fill_(a)
    elif _is_int_seq(a):
        for i, v in enumerate(a):
            buf[i].fill_(v)
    else:
        for b, x in zip(buf, a):
            _fill(b, x, device)


def _fresh(out):
    """Each tensor of a step's output copied (None stays None)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if out is None:
        return None
    fields = [_fresh(x) for x in out]
    return type(out)(*fields) if hasattr(out, "_fields") else type(out)(fields)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: object
    launches: list  # per replay, in _counters() order


class CapturedStep:
    """``step(*args)`` captured as a CUDA graph per input signature on a
    CUDA ``device``, called as it is elsewhere (see the module docstring).
    ``eager`` is the uncaptured step; attributes the builders attach
    (``rects``, ``dims``) are plain attributes."""

    def __init__(self, step, device, max_graphs: int = 4):
        self.eager = step
        self.device = torch.device(device)
        self.max_graphs = max_graphs
        self._graphs: collections.OrderedDict = collections.OrderedDict()

    def __call__(self, *args):
        if self.device.type != "cuda":
            return self.eager(*(torch.tensor(a, dtype=torch.int32, device=self.device)
                                if _is_int_seq(a) else a for a in args))
        key = tuple(_spec(a) for a in args)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, args)
        else:
            self._graphs.move_to_end(key)
            for buf, a in zip(entry.inputs, args):
                _fill(buf, a, self.device)
        entry.graph.replay()
        for (obj, name), n in zip(_counters(), entry.launches):
            setattr(obj, name, getattr(obj, name) + n)
        return _fresh(entry.outputs)

    @property
    def graphs(self) -> int:
        """The number of graphs held."""
        return len(self._graphs)

    def _capture(self, key, args) -> _Graph:
        dev = self.device
        inputs = tuple(_buffer(s, dev) for s in key)
        for buf, a in zip(inputs, args):
            _fill(buf, a, dev)
        counters = _counters()
        before = _read_counters(counters)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.eager(*inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        warm = _read_counters(counters)
        # thread-local capture: a driver's producer thread may allocate,
        # copy and wait on events while this thread captures, which global
        # capture forbids to every thread of the process
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = self.eager(*inputs)
        launches = [a - b for a, b in zip(_read_counters(counters), warm)]
        for (obj, name), n in zip(counters, before):
            setattr(obj, name, n)
        while len(self._graphs) >= self.max_graphs:
            self._graphs.popitem(last=False)
        entry = _Graph(graph, inputs, outputs, launches)
        self._graphs[key] = entry
        return entry


def captured(step, device, max_graphs: int = 4, **attrs) -> CapturedStep:
    """``step`` as a :class:`CapturedStep` on ``device`` with ``attrs`` set
    on it (the builders' ``rects`` and ``dims``)."""
    out = CapturedStep(step, device, max_graphs)
    for k, v in attrs.items():
        setattr(out, k, v)
    return out
