"""Spans and counters of the port's host pipeline, with the card's time
from CUDA events (replaces the reference's ENABLE_PROFILE hooks).

Counterpart of ``obs_color_monitor_tpu/pipeline/profiler.py``: the same
probe names and the same ``enable/reset/summary/probe`` API.  The reference
wraps hot sections with the libobs profiler when compiled with
ENABLE_PROFILE (reference CMakeLists.txt:15, src/common.c:10-21); here the
recorder is switched at run time and is off by default.

* ``span(name, fid=None)`` (``probe(name)`` is one) records the span's
  name, its frame id, its parent (the innermost span open on the same
  thread), its thread and its start and end on ``time.perf_counter()``'s
  clock.  A span inherits its parent's frame id; a span with no parent, or
  given :data:`NEW`, starts a new one.  The pipeline driver carries a
  frame's id through its queue, so the spans of one frame share it from
  the producer's push to the sink.
* ``count(name, n=1)`` adds to a counter and records when and in which
  frame it did.
* ``enqueued()`` / ``dequeued(fid)``, at a queue's push and pop, carry a
  frame's id across threads and record its ``queue.wait``.
* ``device_start(device)`` / ``device_stop(token, name)`` time the work
  issued between them on the device's current stream with a pair of CUDA
  events from a small reused pool, never synchronised: a pair's time is
  read when its slot comes round again (``events.unresolved`` counts a
  pair still pending then) or at :func:`snapshot`.  Nothing is made on the
  CPU.
* :func:`snapshot` returns what was recorded as plain data.

Records go into a ring of preallocated columns of machine numbers (names
interned to small ints), so a span creates no Python object for the
garbage collector to track; when the ring is full further records are
counted as ``profiler.spans_lost``, not kept.  :func:`summary` reads
per-thread running totals.  While off, every site costs one test of a module-level
flag: no lock, no allocation, no clock read, no CUDA call.
``start_trace``/``stop_trace`` wrap a ``torch.profiler.profile`` of the
host and, where present, the CUDA device and write a Chrome trace, in
which each span is a ``record_function`` range while the trace runs.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
import time
import weakref
from array import array
from pathlib import Path
from typing import Optional

import torch

CAPACITY = 1 << 18  # records kept between two resets
EVENT_PAIRS = 256  # CUDA event pairs per device, reused in turn
MAX_DEPTH = 64  # spans open at once on one thread
_PUSHED = 1 << 12  # push times kept for the frames in a queue, by frame id

SPAN, COUNT, DEVICE = 0, 1, 2  # record kinds

NEW = object()  # span(name, NEW): the span starts a new frame id

_enabled = False
_lock = threading.Lock()  # name interning, thread registration
_trace: Optional[tuple[torch.profiler.profile, Path]] = None
_names: list[str] = []
_kind_of: list[int] = []  # by name id: SPAN or COUNT
_ids: dict[str, int] = {}
_threads: list = []  # every thread's _Thread
_local = threading.local()
_fids = itertools.count()
_tids = itertools.count()
_pushed = [0.0] * _PUSHED
_pools: dict = {}  # device index -> _Pool


class _Ring:
    """``n`` records in columns of machine numbers; a record's slot is taken
    from one counter, so threads never write the same slot.  ``kind`` is
    written last (-1 until then)."""

    def __init__(self, n: int):
        self.n = n
        self.seq = itertools.count()
        self.kind = array("b", [-1]) * n
        self.name, self.thread = (array("i", bytes(4 * n)) for _ in range(2))
        self.fid, self.parent = (array("q", bytes(8 * n)) for _ in range(2))
        self.t0, self.t1, self.val = (array("d", bytes(8 * n)) for _ in range(3))


_ring = _Ring(0)


def _intern(name: str, kind: int = SPAN) -> int:
    """The name's id; a new name is of ``kind`` (a device pair shares its
    host span's name and stays a span)."""
    k = _ids.get(name)
    if k is None:
        with _lock:
            k = _ids.setdefault(name, len(_names))
            if k == len(_names):
                _names.append(name)
                _kind_of.append(kind)
    return k


_LOST = _intern("profiler.spans_lost", COUNT)
_UNRESOLVED = _intern("events.unresolved", COUNT)
_QUEUE_WAIT = _intern("queue.wait")


class _Thread:
    """One thread's stack of open spans and its running totals.  ``span``
    hands out this one object: ``with`` statements nest, so its
    ``__enter__`` and ``__exit__`` push and pop the stack."""

    def __init__(self, tid: int, thread: threading.Thread):
        self.id, self.ref, self.label = tid, weakref.ref(thread), thread.name
        self.depth = 0
        self.next_name, self.next_fid = 0, None
        self.names = [0] * MAX_DEPTH
        self.slots = [-1] * MAX_DEPTH
        self.fids = [-1] * MAX_DEPTH
        self.rings = [None] * MAX_DEPTH
        self.t0 = [0.0] * MAX_DEPTH
        self.rf = [None] * MAX_DEPTH
        self.totals_of = None  # the ring the totals below belong to
        self.n: list[int] = []  # by name id: spans ended, counter sums
        self.total: list[float] = []  # by name id: span seconds

    def add(self, k: int, n, dt: float = 0.0) -> None:
        """Add to name ``k``'s totals, started afresh after a reset (only
        this thread writes them)."""
        if self.totals_of is not _ring:
            self.totals_of, self.n, self.total = _ring, [], []
        if k >= len(self.n):
            grow = k + 1 - len(self.n)
            self.n += [0] * grow
            self.total += [0.0] * grow
        self.n[k] += n
        self.total[k] += dt

    def top(self) -> tuple[int, int]:
        """(slot, frame id) of the innermost open span; (-1, -1) if none."""
        d = min(self.depth, MAX_DEPTH)
        return (self.slots[d - 1], self.fids[d - 1]) if d else (-1, -1)

    def __enter__(self):
        d = self.depth
        self.depth = d + 1
        if d >= MAX_DEPTH:
            return None
        parent, up = (self.slots[d - 1], self.fids[d - 1]) if d else (-1, -1)
        k, fid = self.next_name, self.next_fid
        if fid is NEW or (fid is None and d == 0):
            fid = next(_fids)
        elif fid is None:
            fid = up
        ring = _ring
        t0 = time.perf_counter()
        self.names[d], self.fids[d], self.rings[d], self.t0[d] = k, fid, ring, t0
        self.slots[d] = _record(self, ring, SPAN, k, fid, parent, t0, math.nan)
        if _trace is not None:
            rf = torch.profiler.record_function(_names[k])
            rf.__enter__()
            self.rf[d] = rf
        return fid

    def __exit__(self, *exc):
        d = self.depth = self.depth - 1
        if d >= MAX_DEPTH:
            return False
        t1 = time.perf_counter()
        rf = self.rf[d]
        if rf is not None:
            self.rf[d] = None
            rf.__exit__(None, None, None)
        i = self.slots[d]
        if i >= 0:
            self.rings[d].t1[i] = t1
        self.rings[d] = None
        self.add(self.names[d], 1, t1 - self.t0[d])
        return False


def _record(ctx: _Thread, ring: _Ring, kind: int, k: int, fid: int, parent: int,
            t0: float, t1: float, val: float = math.nan) -> int:
    """One record in the ring; its slot, or -1 (counted lost) when full."""
    i = next(ring.seq)
    if i >= ring.n:
        ctx.add(_LOST, 1)
        return -1
    ring.name[i], ring.fid[i], ring.parent[i], ring.thread[i] = k, fid, parent, ctx.id
    ring.t0[i], ring.t1[i], ring.val[i] = t0, t1, val
    ring.kind[i] = kind
    return i


def _thread() -> _Thread:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        with _lock:
            ctx = _local.ctx = _Thread(next(_tids), threading.current_thread())
            _threads.append(ctx)
    return ctx


_OFF = contextlib.nullcontext()  # what span() returns while the recorder is off


def enable(on: bool = True) -> None:
    """Switch the recorder on or off; the first switch on makes the ring."""
    global _enabled
    if on and _ring.n != CAPACITY:
        reset()
    _enabled = on


def reset() -> None:
    """Forget every record and total: a new ring of ``CAPACITY`` records
    (an event pair pending from before is read into the old one)."""
    global _ring
    with _lock:
        _ring = _Ring(CAPACITY)
        _threads[:] = [t for t in _threads if t.ref() is not None]


def _totals(kind: int) -> dict[str, tuple[float, float]]:
    """name -> (count, seconds) summed over the threads' totals since the
    last reset, for the names of ``kind``."""
    out: dict[str, tuple[float, float]] = {}
    for t in list(_threads):
        if t.totals_of is _ring:
            for k, (c, s) in enumerate(zip(list(t.n), list(t.total))):
                if c and _kind_of[k] == kind:
                    c0, s0 = out.get(_names[k], (0, 0.0))
                    out[_names[k]] = (c0 + c, s0 + s)
    return out


def summary() -> dict[str, dict[str, float]]:
    """Per-probe count/total/mean seconds."""
    return {k: {"count": c, "total_s": s, "mean_s": s / c}
            for k, (c, s) in _totals(SPAN).items()}


def span(name: str, fid=None):
    """A named span: ``with span("dock.settled"): ...``.  ``fid`` is the
    frame id (None: the parent's, or a new one for a span without a parent;
    :data:`NEW`: a new one); ``with`` gives the span's frame id (None while
    off)."""
    if not _enabled:
        return _OFF
    ctx = _thread()
    ctx.next_name, ctx.next_fid = _intern(name), fid
    return ctx


def probe(name: str):
    """Named probe (probe names mirror the reference's:
    'render_target', 'convert_yuv', 'draw_vectorscope', ...)."""
    return span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, recorded in the innermost open
    span's frame."""
    if not _enabled:
        return
    ctx = _thread()
    k = _intern(name, COUNT)
    parent, fid = ctx.top()
    t = time.perf_counter()
    _record(ctx, _ring, COUNT, k, fid, parent, t, t, float(n))
    ctx.add(k, n)


def enqueued() -> Optional[int]:
    """The frame id of this thread's innermost open span, whose frame is
    being pushed into a queue now (the start of its ``queue.wait``); None
    while off or outside any span."""
    if not _enabled:
        return None
    fid = _thread().top()[1]
    if fid < 0:
        return None
    _pushed[fid % _PUSHED] = time.perf_counter()
    return fid


def dequeued(fid: Optional[int]) -> None:
    """Frame ``fid`` left its queue: its ``queue.wait`` span, on this thread."""
    if not _enabled or fid is None:
        return
    t1 = time.perf_counter()
    t0 = _pushed[fid % _PUSHED]
    ctx = _thread()
    _record(ctx, _ring, SPAN, _QUEUE_WAIT, fid, -1, t0, t1)
    ctx.add(_QUEUE_WAIT, 1, t1 - t0)


class _Pool:
    """``EVENT_PAIRS`` timing-event pairs of one device, used in turn."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seq = itertools.count()
        self.start: list = [None] * EVENT_PAIRS
        self.end: list = [None] * EVENT_PAIRS
        self.t0 = [0.0] * EVENT_PAIRS
        self.ring: list = [None] * EVENT_PAIRS
        self.slot = [-1] * EVENT_PAIRS
        self.pending = [False] * EVENT_PAIRS

    def resolve(self, k: int, ctx: Optional[_Thread] = None) -> None:
        """The time of pair ``k`` into its record, if its end has passed on
        the device; else counted unresolved (when ``ctx`` reuses the slot)."""
        if not self.pending[k]:
            return
        if self.end[k].query():
            self.pending[k] = False
            ring, i = self.ring[k], self.slot[k]
            if i >= 0:
                ring.val[i] = self.start[k].elapsed_time(self.end[k])
        elif ctx is not None:
            self.pending[k] = False
            ctx.add(_UNRESOLVED, 1)


def device_start(device) -> int:
    """A timing event recorded now on ``device``'s current stream; the token
    for :func:`device_stop` (-1 while off or off a card)."""
    if not _enabled or device.type != "cuda":
        return -1
    idx = device.index if device.index is not None else torch.cuda.current_device()
    pool = _pools.get(idx)
    if pool is None:
        pool = _pools[idx] = _Pool(torch.device("cuda", idx))
    k = next(pool.seq) % EVENT_PAIRS
    pool.resolve(k, _thread())
    if pool.start[k] is None:
        pool.start[k] = torch.cuda.Event(enable_timing=True)
        pool.end[k] = torch.cuda.Event(enable_timing=True)
    pool.start[k].record(torch.cuda.current_stream(pool.device))
    pool.t0[k] = time.perf_counter()
    return idx * EVENT_PAIRS + k


def device_stop(token: int, name: str) -> None:
    """The closing event of ``token``'s pair, on the same stream; the pair
    becomes a ``name`` record of the current frame, its time read later."""
    if token < 0 or not _enabled:
        return
    pool = _pools[token // EVENT_PAIRS]
    k = token % EVENT_PAIRS
    pool.end[k].record(torch.cuda.current_stream(pool.device))
    ctx = _thread()
    parent, fid = ctx.top()
    ring = _ring
    pool.ring[k] = ring
    pool.slot[k] = _record(ctx, ring, DEVICE, _intern(name), fid, parent, pool.t0[k],
                           time.perf_counter())
    pool.pending[k] = True


def snapshot() -> dict:
    """Everything recorded since the last reset, as plain data: ``spans``
    (``id``, ``name``, ``fid``, ``parent`` (an id or None), ``thread``,
    ``t0``, ``t1`` (None while open)), ``device`` (event pairs: ``name``,
    ``fid``, ``span`` (the host span they were stopped in), ``thread``,
    ``t0`` and ``t1`` (host times of the two records), ``ms`` (device
    time, None if unresolved)), ``counts`` (counter increments: ``name``,
    ``fid``, ``span``, ``thread``, ``t``, ``n``), ``counters`` (totals) and
    ``threads`` (id -> name).  Pending event pairs whose end has passed are
    read first."""
    for pool in _pools.values():
        for k in range(EVENT_PAIRS):
            pool.resolve(k)
    ring = _ring
    n = min(next(ring.seq), ring.n)
    cols = {c: getattr(ring, c)[:n].tolist()
            for c in ("kind", "name", "fid", "parent", "thread", "t0", "t1", "val")}
    rows = zip(range(n), *(cols[c] for c in ("kind", "name", "fid", "parent", "thread", "t0",
                                             "t1", "val")))
    spans, device, counts = [], [], []
    for i, kind, k, fid, parent, tid, t0, t1, val in rows:
        par = parent if parent >= 0 else None
        if kind == SPAN:
            spans.append({"id": i, "name": _names[k], "fid": fid, "parent": par, "thread": tid,
                          "t0": t0, "t1": None if math.isnan(t1) else t1})
        elif kind == DEVICE:
            device.append({"name": _names[k], "fid": fid, "span": par, "thread": tid, "t0": t0,
                           "t1": t1, "ms": None if math.isnan(val) else val})
        elif kind == COUNT:
            counts.append({"name": _names[k], "fid": fid, "span": par, "thread": tid, "t": t0,
                           "n": val})
    return {"spans": spans, "device": device, "counts": counts,
            "counters": {k: c for k, (c, _) in _totals(COUNT).items()},
            "threads": {t.id: t.label for t in list(_threads) if t.totals_of is ring}}


def start_trace(log_dir: str) -> None:
    """Start a trace of the host and the CUDA device (view the Chrome trace
    that :func:`stop_trace` writes to ``log_dir`` in chrome://tracing or
    Perfetto)."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace = (prof, Path(log_dir))


def stop_trace() -> Path:
    """Stop the trace and write it; returns the trace file's path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running")
    (prof, log_dir), _trace = _trace, None
    prof.stop()
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    return path
