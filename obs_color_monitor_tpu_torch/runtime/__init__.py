"""Native (C++) host runtime: frame queue, NV12 unpack, pattern sources
(counterpart of ``obs_color_monitor_tpu/runtime/__init__.py``)."""

from .native import (
    NativeFrameQueue,
    available,
    deinterleave_rgba,
    nv12_to_rgba,
    pattern,
)

__all__ = [
    "NativeFrameQueue",
    "available",
    "deinterleave_rgba",
    "nv12_to_rgba",
    "pattern",
]
