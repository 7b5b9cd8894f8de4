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

* it owns static input buffers, one per argument, and takes the arguments
  the JAX steps take (:func:`_host_arg` sorts them): a tensor (a frame, a
  plane of an NV12 pair, a rect, a batch of clocks) is copied into its
  buffer device to device; a host array (numpy, JAX) is copied into it
  from host memory, straight, as ``ops.convert._as_device_arg`` would make
  it (a uint32 frame as its int32 view), so it shares the graph of its
  tensor twin; a number (the zebra clock ``tm``: a Python or numpy number,
  a 0-d array) is written into a 0-d float32 buffer with ``fill_``, and a
  host rect (a sequence of Python or numpy ints, a 1-d integer array) into
  an int32 buffer element by element, also with ``fill_``, which passes
  each value as a kernel argument: neither is copied from host memory.  A
  number and a 0-d float32 tensor share a buffer, and so do a host rect
  and a (4,) int32 tensor; a tuple of planes (an NV12 pair) is a tuple of
  buffers;
* on the first call with a new signature (the shapes and dtypes of the
  arguments) it runs the step twice on a side stream (the warm-up, which
  builds the kernels and every cached constant), then captures one call
  with ``torch.cuda.graph`` in thread-local mode, so that other threads
  (a pipeline driver's producer) may go on working meanwhile.  It captures
  on a stream that no other code of the package draws
  (:func:`capture_stream`): work that another thread issues to a stream
  under capture joins the graph, and an event recorded there cannot be
  waited on ("CUDA error: invalid argument").  Python's
  cyclic collector is held off during the capture: a dead reference cycle
  that holds another graph (a Dock and its settled step refer to each
  other) would destroy that graph mid-capture, which CUDA does not permit
  and which spoils the capture; the cycle goes at a later collection.  A
  capture that fails raises: there is no eager fallback;
* every call copies the arguments in, replays, and returns fresh output
  tensors, one device copy per field, so a result never changes at a later
  call (as JAX's returned arrays do not);
* it keeps at most ``max_graphs`` graphs, dropping the least recently used
  (with it, its memory pool);
* with the profiler on (``pipeline.profiler``), a call is a ``step.call``
  span holding ``step.fill``, ``step.replay`` (and its device time, from a
  pair of CUDA events), ``step.clone`` or, for a new signature,
  ``step.capture``; the counters ``step.captures`` and ``step.evictions``
  count the graphs made and dropped;
* the kernel wrappers count their launches in Python, which a replay does
  not run, so each graph records the launches its capture made and every
  replay adds them.  The warm-up and the capture are set-up: the counters
  are restored after them, and they count only the replays' launches.

On the CPU the step runs uncaptured on the same arguments placed on the
CPU (a host array as its tensor, a host rect as an int32 tensor, a number
as a float).  ``step.eager`` is the uncaptured function on any device.
A host argument never moves a step off its device.
"""

from __future__ import annotations

import collections
import gc
from typing import NamedTuple

import numpy as np
import torch

from .api import check_device
from .ops.convert import _as_device_arg, _host_array
from .pipeline import profiler


def _counters() -> list:
    """(wrapper, attribute) of every kernel launch counter."""
    from .ops import compose, decode, fused_overlays, pipeline, render, scope_stats

    vs = scope_stats.vs_wv_counts
    fo = fused_overlays.fused_overlays_planes
    return [(pipeline.frame_pass, "launches"), (pipeline.frame_pass, "launches_vec"),
            (vs, "launches"), (vs, "launches_vec"), (vs, "launches_vs_only"),
            (vs, "launches_wv_only"), (vs, "launches_rect"),
            (fo, "launches"), (fo, "launches_rect"), (fo, "launches_vec"),
            (decode.nv12_decode, "launches"), (decode.nv12_16_decode, "launches"),
            (compose.compose_panel, "launches"), (render.draw_stat_images, "launches")]


def _read_counters(counters) -> list[int]:
    return [getattr(obj, name) for obj, name in counters]


_capture_streams: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every capture on ``device`` records on: a stream of
    PyTorch's high-priority pool, which nothing else in the package draws
    from.  ``torch.cuda.graph``'s own default is a stream of the
    default-priority pool, which hands out its 32 streams in turn, so the
    32nd stream drawn after it (a driver's upload stream, say) would be
    the capture's own.  A replay runs on the caller's stream: the capture
    stream's priority does not carry over."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    stream = _capture_streams.get(idx)
    if stream is None:
        stream = _capture_streams[idx] = torch.cuda.Stream(torch.device("cuda", idx),
                                                           priority=-1)
    return stream


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)


def _is_int_seq(a) -> bool:
    return isinstance(a, tuple) and all(isinstance(v, int) for v in a)


def _host_arg(a):
    """One step argument in the form the buffers take: a tensor as it is; a
    number or a 0-d numeric array as a float (a clock); a sequence of
    integers or a 1-d integer array as a tuple of ints (a rect); a
    sequence of arrays (an NV12 pair) as a tuple of these forms; any other
    array-like as ``_host_array``'s numpy array.  ``TypeError`` for
    anything else."""
    if isinstance(a, torch.Tensor):
        return a
    if isinstance(a, (tuple, list)) and not all(_is_number(v) for v in a):
        return tuple(_host_arg(x) for x in a)
    if _is_number(a):
        return float(a)
    arr = _host_array(a)
    if arr.ndim == 0:
        return float(arr)
    if arr.ndim == 1 and arr.dtype.kind in "iu":
        return tuple(int(v) for v in arr.tolist())
    return arr


def _spec(a):
    """The signature of one argument in :func:`_host_arg`'s form: ("t",
    shape, dtype) for what becomes one buffer, ("seq", specs) for a tuple
    of planes (an NV12 pair)."""
    if isinstance(a, torch.Tensor):
        return ("t", tuple(a.shape), a.dtype)
    if isinstance(a, np.ndarray):
        return ("t", a.shape, torch.from_numpy(a).dtype)
    if isinstance(a, float):
        return ("t", (), torch.float32)
    if _is_int_seq(a):
        return ("t", (len(a),), torch.int32)
    return ("seq", tuple(_spec(x) for x in a))


def _on_device(a, device):
    """One argument in :func:`_host_arg`'s form as the uncaptured step
    takes it on ``device``."""
    if isinstance(a, float):
        return a
    if _is_int_seq(a):
        return torch.tensor(a, dtype=torch.int32, device=device)
    if isinstance(a, tuple):
        return tuple(_on_device(x, device) for x in a)
    return _as_device_arg(a, device)


def _buffer(spec, device):
    if spec[0] == "seq":
        return tuple(_buffer(s, device) for s in spec[1])
    return torch.empty(spec[1], dtype=spec[2], device=device)


def _fill(buf, a, device) -> None:
    """Write one argument into its buffer, on the current stream."""
    if isinstance(a, torch.Tensor):
        check_device(a, device)
        buf.copy_(a)
    elif isinstance(a, np.ndarray):
        buf.copy_(torch.from_numpy(a))
    elif isinstance(a, float):
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
        with profiler.span("step.call"):
            return self._call(args)

    def _call(self, args):
        args = tuple(_host_arg(a) for a in args)
        if self.device.type != "cuda":
            return self.eager(*(_on_device(a, self.device) for a in args))
        key = tuple(_spec(a) for a in args)
        entry = self._graphs.get(key)
        if entry is None:
            with profiler.span("step.capture"):
                entry = self._capture(key, args)
        else:
            self._graphs.move_to_end(key)
            with profiler.span("step.fill"):
                for buf, a in zip(entry.inputs, args):
                    _fill(buf, a, self.device)
        with profiler.span("step.replay"):
            ev = profiler.device_start(self.device)
            entry.graph.replay()
            profiler.device_stop(ev, "step.replay")
        for (obj, name), n in zip(_counters(), entry.launches):
            setattr(obj, name, getattr(obj, name) + n)
        with profiler.span("step.clone"):
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
        # capture forbids to every thread of the process.  No collection
        # meanwhile: a graph destroyed during a capture spoils it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=capture_stream(dev),
                                  capture_error_mode="thread_local"):
                outputs = self.eager(*inputs)
        finally:
            if collecting:
                gc.enable()
        launches = [a - b for a, b in zip(_read_counters(counters), warm)]
        for (obj, name), n in zip(counters, before):
            setattr(obj, name, n)
        while len(self._graphs) >= self.max_graphs:
            self._graphs.popitem(last=False)
            profiler.count("step.evictions")
        entry = _Graph(graph, inputs, outputs, launches)
        self._graphs[key] = entry
        profiler.count("step.captures")
        return entry


def captured(step, device, max_graphs: int = 4, **attrs) -> CapturedStep:
    """``step`` as a :class:`CapturedStep` on ``device`` with ``attrs`` set
    on it (the builders' ``rects`` and ``dims``)."""
    out = CapturedStep(step, device, max_graphs)
    for k, v in attrs.items():
        setattr(out, k, v)
    return out
