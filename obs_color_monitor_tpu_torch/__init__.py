"""obs_color_monitor_tpu_torch — the six-scope step in PyTorch and CUDA.

The port of :mod:`obs_color_monitor_tpu` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for the NVIDIA H100; counterpart of
``obs_color_monitor_tpu/__init__.py``.  The JAX package stays the
reference: this package reuses its jax-free spec modules (``colorspace``,
``config``, ``golden``) and imports no JAX itself.

Layout:
  api.py        make_full_step / ScopeOutputs (the six-scope step)
  ops/          convert, overlays, stats, render (plain torch);
                pipeline (kernel K1) and scope_stats (kernel K2) wrappers
  ops/csrc/     the CUDA sources, built by nvcc at first use (_kernels.py)

Every kernel wrapper picks its route from its input's device: a CPU tensor
runs the plain PyTorch version, a CUDA tensor launches the kernel.
"""

from .api import ScopeOutputs, frame_from_numpy, make_full_step
from .spec import (
    Colorspace,
    Components,
    DisplayMode,
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    LevelMode,
    VectorscopeConfig,
    WaveformConfig,
    ZebraConfig,
    calc_colorspace,
)

__version__ = "0.1.0"

__all__ = [
    "Colorspace",
    "calc_colorspace",
    "Components",
    "DisplayMode",
    "LevelMode",
    "VectorscopeConfig",
    "WaveformConfig",
    "HistogramConfig",
    "ZebraConfig",
    "FalseColorConfig",
    "FocusPeakingConfig",
    "ScopeOutputs",
    "frame_from_numpy",
    "make_full_step",
]
