"""Host pipeline: bounded queue, driver, profiling probes, ingest and sinks
(counterpart of ``obs_color_monitor_tpu/pipeline/__init__.py``, the same
``__all__``)."""

from .queue import FrameQueue, DEFAULT_QUEUE_DEPTH
from .driver import NV12Frame, PipelineDriver
from .targets import (
    FrameChannel,
    TargetDirectory,
    TargetedPipeline,
    PROGRAM,
    MAINVIEW,
    PREVIEW,
)
from . import profiler

__all__ = [
    "FrameQueue",
    "DEFAULT_QUEUE_DEPTH",
    "PipelineDriver",
    "NV12Frame",
    "FrameChannel",
    "TargetDirectory",
    "TargetedPipeline",
    "PROGRAM",
    "MAINVIEW",
    "PREVIEW",
    "profiler",
]
