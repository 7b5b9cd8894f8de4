"""Pipeline driver: ingest thread + bounded queue + asynchronous device work.

Counterpart of ``obs_color_monitor_tpu/pipeline/driver.py``.  The reference
pipeline is: graphics thread renders + stages (GPU->CPU copy enqueued), a
per-source pthread maps the staging surface and runs the CPU accumulators,
results publish through a double buffer (reference src/common.c:223-403,
SURVEY.md §3.2).  The port keeps the same *shape* — producer, bounded queue
with drop, consumer, double-buffered publication — with the consumer
issuing the device work (CUDA launches and graph replays return before the
card finishes) and a device sync only at the sink (:meth:`flush`, a host
read of a result), never per frame in the hot path.

On a CUDA device, :meth:`PipelineDriver.push_nv12` uploads on the PRODUCER
thread (the JAX driver's asynchronous ``device_put``): the planes go into
a ring of pinned host buffers and cross on a producer side stream, so the
copy overlaps the worker's device work; the queued frame carries the event
that marks its arrival, and the worker's stream waits on it.

With the profiler on (``pipeline.profiler``), a push is a
``producer.push_nv12`` (or ``producer.push_frame``) span, which starts the
frame's id, holding the stager's ``stager.slot_wait``,
``stager.host_copy`` and ``stager.upload``; the id rides beside the frame
in the queue (``queue.wait``, from the push to the worker's pop; a refused
push counts ``queue.dropped_full`` or ``queue.rejected_closed``), and the
worker's ``pipeline_loop`` span, the Dock's and the captured step's spans
inside it and ``driver.on_panel`` carry it.  A pair of CUDA events times
the frame on the worker's stream from its arrival to its panel
(``frame.device``).  The native fixed-shape queue carries no id: a frame
from it starts a new one at ``pipeline_loop`` and has no ``queue.wait``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING, NamedTuple, Optional

import numpy as np
import torch

from ..ops.convert import _as_device_arg
from . import profiler
from .queue import DEFAULT_QUEUE_DEPTH, FrameQueue

if TYPE_CHECKING:  # the models import the pipeline's profiler
    from ..models.base import CaptureHub

log = logging.getLogger("obs_color_monitor_tpu_torch.pipeline")


class NV12Frame(NamedTuple):
    """A wire-format frame in the driver queue: raw (y, uv) planes +
    decode colorimetry (``shift`` > 0 = 16-bit P010-family planes).  The
    planes are tensors on the hub's device by the time this sits in the
    queue — push_nv12 stages the upload on the PRODUCER thread, the analog
    of the reference's graphics thread staging the texture while the
    pipeline thread still works the previous frame (src/common.c:335-403).
    On a CUDA device ``ready`` is the event recorded after the upload on
    the producer's stream (None on the CPU)."""

    y: object
    uv: object
    cs: Optional[int]
    shift: int
    ready: Optional[torch.cuda.Event] = None


class _PinnedStager:
    """Host-to-device upload of NV12 frames off the worker's stream.

    A ring of ``slots`` pinned host buffers, each with an event, allocated
    at the first push for the frame's shape: a frame's planes are copied
    into the next slot as one (H + H/2, W) block, which crosses with one
    ``non_blocking`` copy on a side stream, followed by the slot's event.
    Before a slot is reused the producer waits on its event (the copy out
    of it has finished), so in steady state the producer allocates no host
    memory and makes no call that another thread's graph capture forbids
    beyond the device block the caching allocator hands out.
    ``host_copy_s`` and ``wait_s`` total the producer's time in the host
    copy and waiting for a slot.  Producers on several threads take turns
    (one lock around a whole upload)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.n_slots = slots
        self.stream = torch.cuda.Stream(device)
        self._lock = threading.Lock()
        self._key = None
        self._bufs: list[torch.Tensor] = []
        self._events: list[torch.cuda.Event] = []
        self._next = 0
        self.n_uploads = 0
        self.host_copy_s = 0.0
        self.wait_s = 0.0

    def _ring(self, shape: tuple[int, int], dtype: np.dtype) -> None:
        key = (shape, dtype)
        if key == self._key:
            return
        for ev in self._events:  # a slot of the old shape may still be read
            ev.synchronize()
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        self._bufs = [torch.empty(shape, dtype=tdtype, pin_memory=True)
                      for _ in range(self.n_slots)]
        self._events = [torch.cuda.Event() for _ in range(self.n_slots)]
        for ev in self._events:  # created now, not at a later record
            ev.record(self.stream)
        self._key, self._next = key, 0

    def upload(self, y: np.ndarray, uv: np.ndarray):
        """(y, uv) on the device as row slices of one block, and the event
        after which they are there."""
        with self._lock:
            return self._upload(y, uv)

    def _upload(self, y: np.ndarray, uv: np.ndarray):
        h, w = y.shape
        self._ring((h + uv.shape[0], w), y.dtype)
        k = self._next
        self._next = (k + 1) % self.n_slots
        buf, ev = self._bufs[k], self._events[k]
        t0 = time.perf_counter()
        with profiler.span("stager.slot_wait"):
            ev.synchronize()
        t1 = time.perf_counter()
        with profiler.span("stager.host_copy"):
            host = buf.numpy()
            np.copyto(host[:h], y)
            np.copyto(host[h:], uv)
        self.host_copy_s += time.perf_counter() - t1
        self.wait_s += t1 - t0
        with profiler.span("stager.upload"), torch.cuda.stream(self.stream):
            dev = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
            dev.copy_(buf, non_blocking=True)
            ev.record(self.stream)
        self.n_uploads += 1
        return dev[:h], dev[h:], ev


def _host_planes(y, uv) -> tuple[np.ndarray, np.ndarray]:
    y, uv = np.asarray(y), np.asarray(uv)
    if (y.ndim != 2 or uv.ndim != 2 or y.dtype != uv.dtype
            or y.dtype not in (np.uint8, np.uint16) or uv.shape[1] != y.shape[1]):
        raise ValueError(f"expected NV12 planes (H, W) and (H/2, W) of u8 or u16, got "
                         f"{y.dtype} {y.shape} and {uv.dtype} {uv.shape}")
    return y, uv


class PipelineDriver:
    """Drives a CaptureHub — or a whole Dock — from a frame stream.

    push_frame() is the producer side (non-blocking, drop-on-full); a worker
    thread runs the hub's fused pass in frame order.  Mirrors the
    reference's one-pipeline-thread-per-source design
    (src/common.c:430-454), generalized to the shared-hub case.

    With ``dock=`` the worker consumes through the Dock's push/render
    deferral instead of the bare hub fan-out: each frame runs
    ``dock.push_frame`` + ``dock.render_async`` — push/render alternation
    is what engages the Dock's settled route (analysis, every scope render
    and the composite replayed as one CUDA graph per frame, models/dock.py),
    so a driver-fed dock gets the fast streaming path the reference's
    single pipeline gets by construction (src/common.c:375-403).
    ``on_panel`` (optional) receives each device-resident panel on the
    worker thread — a sink can fetch/encode it (blocking there is fine: the
    work is issued).  The worker serializes all dock access under the
    driver lock; cross-thread reads should use the scopes' double-buffered
    accessors (counts()/render()), which is what they exist for.

    The CLI ``--live`` loop (``__main__.py``) does NOT sit on this driver:
    its readback pipelining (publish frame i−1 while frame i's host copy is
    in flight) and upload-before-publish ordering need per-frame index
    bookkeeping across produce/publish, which the fire-and-forget
    ``on_panel`` contract would hide.  Both stacks share the same consume
    path; the driver is the embedding surface (queue + thread +
    drop/backpressure), the CLI loop is the paced-source surface.

    The hub's device decides where frames go: on a CUDA device push_nv12
    stages pinned uploads on a side stream (``queue_depth + 2`` slots) and
    the worker records an event after each frame, on which :meth:`flush`
    waits; on the CPU the planes are copied into CPU tensors.
    """

    def __init__(
        self,
        hub: Optional[CaptureHub] = None,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        native_queue_shape: Optional[tuple[int, ...]] = None,
        *,
        dock=None,
        on_panel=None,
    ):
        if (hub is None) == (dock is None):
            raise ValueError("pass exactly one of hub= or dock=")
        if dock is not None:
            hub = dock.hub
        self._dock = dock
        self._on_panel = on_panel
        self.hub = hub
        self.device = hub.device
        self._queue_depth = queue_depth
        self._native_queue_shape = native_queue_shape
        self.queue = self._make_queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._lock = threading.Lock()
        self._state_lock = threading.Lock()  # start/stop mutual exclusion
        self._queue_closed = False
        self._consumed = 0  # frames fully handled by the worker (see flush)
        self.n_errors = 0
        self._stager: Optional[_PinnedStager] = None
        # recorded on the worker's stream after each frame (CUDA only)
        self._done: Optional[torch.cuda.Event] = None

    def _make_queue(self):
        if self._native_queue_shape is not None:
            # fixed-shape ingest -> use the C++ queue (one memcpy, no GIL
            # contention with the consumer thread)
            from ..runtime import NativeFrameQueue

            return NativeFrameQueue(self._queue_depth, self._native_queue_shape)
        return FrameQueue(self._queue_depth)

    # -- lifecycle (reference start/stop_pipeline_thread) -------------------
    def start(self) -> None:
        with self._state_lock:
            if self._running:
                return
            if self._queue_closed:
                # a closed queue rejects every push forever — a restarted
                # driver needs a fresh one (queue counters restart with it,
                # so the consumed counter restarts too to keep flush exact)
                self.queue = self._make_queue()
                self._queue_closed = False
                self._consumed = 0
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name="color-monitor", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._state_lock:
            if not self._running:
                return
            self._running = False
            self.queue.close()
            self._queue_closed = True
            if self._thread is not None:
                self._thread.join()
                self._thread = None

    # -- producer ------------------------------------------------------------
    def push_frame(self, frame) -> bool:
        """Non-blocking enqueue; False = dropped (queue full)."""
        with profiler.span("producer.push_frame", profiler.NEW):
            return self._enqueue(frame)

    def _enqueue(self, item) -> bool:
        """Push ``item`` with the producer's frame id beside it (the
        profiler's; None while it is off); a refused push is counted by its
        cause."""
        fid = profiler.enqueued()
        if self.queue.push(item, fid):
            return True
        profiler.count("queue.rejected_closed" if self.queue.closed else "queue.dropped_full")
        return False

    def push_nv12(self, y, uv, cs: Optional[int] = None, shift: int = 0) -> bool:
        """Enqueue a wire-format NV12/P010 frame (raw planes, decode on the
        device — see Dock.push_nv12).  The upload is issued HERE, on the
        producer thread, before the frame enters the queue (and before the
        queue decides whether to drop it): on a CUDA device through the
        pinned ring on the producer's stream, so the transfer overlaps the
        worker's previous frame, the reference's
        stage-on-the-graphics-thread pattern (src/common.c:335-403).
        Planes that are already tensors on the device are queued as they
        are.  Non-blocking; False = dropped."""
        if self._native_queue_shape is not None:
            raise ValueError(
                "push_nv12 needs the object queue; the native fixed-shape "
                "queue carries single packed frames only"
            )
        with profiler.span("producer.push_nv12", profiler.NEW):
            ready = None
            if isinstance(y, torch.Tensor) and isinstance(uv, torch.Tensor):
                pass
            elif self.device.type == "cuda":
                with self._state_lock:
                    if self._stager is None:
                        self._stager = _PinnedStager(self.device, self._queue_depth + 2)
                y, uv, ready = self._stager.upload(*_host_planes(y, uv))
            else:
                # copies: the producer may refill its buffers once push returns
                y, uv = (_as_device_arg(np.array(a, copy=True), self.device)
                         for a in _host_planes(y, uv))
            return self._enqueue(NV12Frame(y, uv, cs, int(shift), ready))

    @property
    def staging(self) -> dict:
        """Where the producer's time went on the CUDA upload route: uploads
        made, seconds in the host copy into pinned memory and waiting for a
        free slot."""
        s = self._stager
        if s is None:
            return {"uploads": 0, "host_copy_s": 0.0, "wait_s": 0.0}
        return {"uploads": s.n_uploads, "host_copy_s": s.host_copy_s, "wait_s": s.wait_s}

    # -- consumer ------------------------------------------------------------
    def _loop(self) -> None:
        log.debug("entering pipeline thread")  # reference common.c:376
        while self._running:
            frame, fid = self.queue.pop_tagged(timeout=0.1)
            if frame is None:
                continue
            profiler.dequeued(fid)
            try:
                with self._lock:
                    with profiler.span("pipeline_loop", fid):
                        self._consume(frame)
            except Exception:
                # a consumer failure must not kill the pipeline thread;
                # the frame is dropped and counted
                self.n_errors += 1
                log.exception("pipeline frame failed (frame dropped)")
            finally:
                # counted only once the frame is fully handled — flush()
                # compares this against the queue's accepted-push count,
                # which a queue-length check can't do (a popped-but-not-
                # yet-processed frame is invisible to both the length
                # and the lock)
                self._consumed += 1
        log.debug("leaving pipeline thread")

    def _arrive(self, frame: NV12Frame) -> None:
        """Order the worker's stream after the frame's upload, and keep the
        planes' memory from the producer's stream until the worker's work on
        them is done."""
        if frame.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(frame.ready)
        frame.y.record_stream(stream)
        frame.uv.record_stream(stream)

    def _consume(self, frame) -> None:
        """One frame through the configured consumer: the dock's
        push/render deferral (the settled route) or the bare hub fan-out
        (dock.push_frame ticks the hub itself)."""
        if isinstance(frame, NV12Frame):
            self._arrive(frame)
        # the card's time on the frame, from its arrival to its panel (a
        # pair of timing events while the profiler is on)
        ev = profiler.device_start(self.device)
        if self._dock is not None:
            if isinstance(frame, NV12Frame):
                self._dock.push_nv12(
                    frame.y, frame.uv, cs=frame.cs, shift=frame.shift
                )
            else:
                self._dock.push_frame(frame)
            panel = self._dock.render_async()
            profiler.device_stop(ev, "frame.device")
            if panel is not None and self._on_panel is not None:
                with profiler.span("driver.on_panel"):
                    self._on_panel(panel)
        else:
            self.hub.tick()
            if isinstance(frame, NV12Frame):
                self.hub.process_nv12(
                    frame.y, frame.uv, cs=frame.cs, shift=frame.shift
                )
            else:
                self.hub.process(frame)
            profiler.device_stop(ev, "frame.device")
        if self.device.type == "cuda":
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self.device))

    # -- synchronous convenience ----------------------------------------------
    def process_now(self, frame) -> None:
        """Run one frame synchronously through the configured consumer
        (tests/tools)."""
        with self._lock:
            self._consume(frame)

    def flush(self, timeout: float = 10.0) -> None:
        """Wait until the queue drains and in-flight work lands.

        "Landed" = the worker finished every frame the queue ACCEPTED
        (``_consumed`` catches up to ``n_pushed``); then, on a CUDA device,
        the event the worker recorded after its last frame is synchronized
        (the JAX driver's ``block_until_ready`` on the last surface: the
        settled Dock publishes copies and does not refresh
        ``hub.last_surface`` on every route, so the event covers what a
        surface would not)."""
        t0 = time.monotonic()
        while (
            self._running
            and self._consumed < self.queue.n_pushed
            and time.monotonic() - t0 < timeout
        ):
            time.sleep(0.001)
        with self._lock:
            if self._done is not None:
                self._done.synchronize()

    # -- metrics ---------------------------------------------------------------
    @property
    def stats(self) -> dict:
        return {
            "pushed": self.queue.n_pushed,
            "dropped": self.queue.n_dropped,
            "processed": self.hub.frames_processed,
            "interleave_skipped": self.hub.frames_skipped,
            "errors": self.n_errors,
        }
