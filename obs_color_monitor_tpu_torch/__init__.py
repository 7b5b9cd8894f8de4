"""obs_color_monitor_tpu_torch — the video scopes in PyTorch and CUDA.

The port of :mod:`obs_color_monitor_tpu` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for the NVIDIA H100; counterpart of
``obs_color_monitor_tpu/__init__.py``.  The JAX package stays the
reference; this package imports nothing of it and no JAX: it keeps its own
copies of the numpy spec modules (``colorspace``, ``config``, ``golden``,
``utils/draw``).

Layout:
  api.py        make_full_step / ScopeOutputs (the six-scope step)
  dock_step.py  make_dock_step / DockStepOutput (the one-panel dock, with
                the dynamic ROI)
  models/       CaptureHub, the six scopes, InteractiveROI and the streaming
                Dock
  ops/          convert, overlays, stats, render, graticule (plain torch or
                numpy); kernel wrappers with their plain versions: pipeline
                (K1, and K9's fused_ingest_stats_scale1/2 as K1 + K2),
                scope_stats (K2), fused_overlays (K3), decode (K4, K5);
                fused.analyze (K1 + K2)
  ops/csrc/     the CUDA sources, built by nvcc at first use (_kernels.py)

Every kernel wrapper picks its route from its input's device: a CPU tensor
runs the plain PyTorch version, a CUDA tensor launches the kernel.  The
entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

from .api import ScopeOutputs, frame_from_numpy, make_full_step
from .colorspace import Colorspace, calc_colorspace
from .config import (
    Components,
    DisplayMode,
    DockConfig,
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    LevelMode,
    ShowKey,
    VectorscopeConfig,
    WaveformConfig,
    ZebraConfig,
    from_reference,
)
from .dock_step import DockStepOutput, make_dock_step
from .ops.convert import nv12_shift

__version__ = "0.2.0"

__all__ = [
    "Colorspace",
    "calc_colorspace",
    "Components",
    "DisplayMode",
    "LevelMode",
    "ShowKey",
    "VectorscopeConfig",
    "WaveformConfig",
    "HistogramConfig",
    "ZebraConfig",
    "FalseColorConfig",
    "FocusPeakingConfig",
    "DockConfig",
    "from_reference",
    "ScopeOutputs",
    "frame_from_numpy",
    "make_full_step",
    "DockStepOutput",
    "make_dock_step",
    "nv12_shift",
]
