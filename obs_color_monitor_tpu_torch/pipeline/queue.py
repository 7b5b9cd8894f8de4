"""Bounded frame queue with drop-on-full backpressure.

Counterpart of ``obs_color_monitor_tpu/pipeline/queue.py`` (a copy, with a
tag beside each item: the driver's frame id, for the profiler's spans).
Mirrors the reference's 3-deep staging queue: the graphics thread drops the
frame when the queue is full rather than blocking (reference
src/common.h:46, src/common.c:260-268), and a consumer thread drains it
(src/common.c:375-403).  Here the producer is frame ingest and the consumer
issues the device work; since PyTorch's CUDA launches are asynchronous, the
queue also bounds the number of frames in flight.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Optional

# Same depth as the reference (CM_SURFACE_QUEUE_SIZE, common.h:46).
DEFAULT_QUEUE_DEPTH = 3


class FrameQueue:
    """Thread-safe bounded queue; push never blocks (drops instead)."""

    def __init__(self, depth: int = DEFAULT_QUEUE_DEPTH):
        self.depth = depth
        self._q: deque[Any] = deque()
        self._tags: deque[Any] = deque()  # beside each item, its tag
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self.n_pushed = 0
        self.n_dropped = 0

    def push(self, item: Any, tag: Any = None) -> bool:
        """Enqueue; returns False (frame dropped) when full
        (reference src/common.c:260-268).  ``tag`` rides beside the item
        (the pipeline driver's frame id), for :meth:`pop_tagged`."""
        with self._cond:
            if self._closed:
                return False
            if len(self._q) >= self.depth:
                self.n_dropped += 1
                return False
            self._q.append(item)
            self._tags.append(tag)
            self.n_pushed += 1
            self._cond.notify()
            return True

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Blocking dequeue; None on close or timeout.

        ``timeout`` bounds the TOTAL wait (wait_for tracks one deadline; a
        bare wait(timeout) in a loop would restart the full timeout on
        every spurious/stolen wakeup)."""
        return self.pop_tagged(timeout)[0]

    def pop_tagged(self, timeout: Optional[float] = None) -> tuple[Any, Any]:
        """:meth:`pop` and the item's tag: (None, None) on close or timeout."""
        with self._cond:
            self._cond.wait_for(lambda: self._q or self._closed, timeout)
            if self._q:
                return self._q.popleft(), self._tags.popleft()
            return None, None

    @property
    def closed(self) -> bool:
        """Whether :meth:`close` was called (every push is refused)."""
        return self._closed

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)
