"""The scopes and the streaming dock (the framework's "model" layer).

Counterpart of ``obs_color_monitor_tpu/models/__init__.py``."""

from .base import CaptureHub, Needs, Scope, SurfaceData
from .dock import SCOPE_ORDER, Dock
from .histogram import Histogram
from .overlays import FalseColor, FocusPeaking, Zebra
from .roi_interact import InteractiveROI
from .vectorscope import Vectorscope
from .waveform import Waveform

__all__ = [
    "CaptureHub",
    "Needs",
    "Scope",
    "SurfaceData",
    "Vectorscope",
    "Waveform",
    "Histogram",
    "Zebra",
    "FalseColor",
    "FocusPeaking",
    "InteractiveROI",
    "Dock",
    "SCOPE_ORDER",
]
