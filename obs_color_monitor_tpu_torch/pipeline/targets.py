"""Capture-target directory: bind hubs to named frame producers
(counterpart of ``obs_color_monitor_tpu/pipeline/targets.py``, a copy on
the port's ``models.base.CaptureHub``).

The reference resolves its capture target every tick by name — the program
feed (empty name), the main view ("\\x01"), the preview ("\\x10"), or any
source by name — holding only a weak reference so a removed source simply
stops producing until it reappears (reference src/common.c:456-543).

Here producers push frames into named :class:`FrameChannel`s registered in
a :class:`TargetDirectory`; a :class:`TargetedPipeline` re-resolves its
target name every tick and feeds its CaptureHub the channel's latest frame.
A missing/removed target is not an error — the hub just idles (the
reference's dangling-weak-ref behavior).
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # the models import the pipeline's profiler
    from ..models.base import CaptureHub

# Special target names (reference src/common.h:9-22).
PROGRAM = ""
MAINVIEW = "\x01"
PREVIEW = "\x10"


class FrameChannel:
    """Latest-frame mailbox for one named producer."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._frame = None
        self._seq = 0

    def push(self, frame) -> None:
        with self._lock:
            self._frame = frame
            self._seq += 1

    def latest(self) -> tuple[int, Optional[object]]:
        with self._lock:
            return self._seq, self._frame


class TargetDirectory:
    """Named channel registry (the reference's obs_get_source_by_name analog).

    The PROGRAM channel always exists (the reference's empty-name target
    renders the main texture, src/common.c:157-162).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._channels: dict[str, FrameChannel] = {PROGRAM: FrameChannel(PROGRAM)}

    def create(self, name: str) -> FrameChannel:
        with self._lock:
            ch = self._channels.get(name)
            if ch is None:
                ch = FrameChannel(name)
                self._channels[name] = ch
            return ch

    def remove(self, name: str) -> None:
        """Source removal (reference obs_source_removed detection,
        src/common.c:498-512)."""
        if name == PROGRAM:
            raise ValueError("cannot remove the program channel")
        with self._lock:
            self._channels.pop(name, None)

    def get(self, name: str) -> Optional[FrameChannel]:
        with self._lock:
            return self._channels.get(name)

    def names(self) -> list[str]:
        """Sorted source list (reference property_list_add_sources,
        src/util-cpp.cc:34-64)."""
        with self._lock:
            special = [n for n in (PROGRAM, MAINVIEW, PREVIEW) if n in self._channels]
            rest = sorted(n for n in self._channels if n not in special)
            return special + rest

    @property
    def program(self) -> FrameChannel:
        return self._channels[PROGRAM]


class TargetedPipeline:
    """A hub bound to a target NAME, re-resolved every tick.

    ``tick()`` mirrors cm_tick (reference src/common.c:575-595): resolve the
    name, and if the channel has a new frame, run the hub's fused pass.
    """

    def __init__(
        self, hub: CaptureHub, directory: TargetDirectory, target_name: str = PROGRAM
    ):
        self.hub = hub
        self.directory = directory
        self.target_name = target_name
        self._last_seq = 0
        self._bound_channel: Optional[FrameChannel] = None

    def set_target(self, name: str) -> None:
        """Settings change (reference cm_update target_name,
        src/common.c:71-83)."""
        if name != self.target_name:
            self.target_name = name
            self._last_seq = 0

    def tick(self) -> bool:
        """Returns True if a frame was processed this tick."""
        self.hub.tick()
        ch = self.directory.get(self.target_name)
        if ch is None:
            self._bound_channel = None  # weak ref released
            return False  # dangling target: idle, no error
        if ch is not self._bound_channel:
            # a NEW source took this name: rebind like the reference's
            # weak-ref refresh (src/common.c:512-526)
            self._bound_channel = ch
            self._last_seq = 0
        seq, frame = ch.latest()
        if frame is None or seq == self._last_seq:
            return False
        self._last_seq = seq
        return self.hub.process(frame) is not None
