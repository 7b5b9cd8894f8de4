"""The specification the port shares with the JAX package.

The JAX package's colorspace constants (``colorspace.py``), scope configs
(``config.py``) and NumPy golden model (``golden/``) are plain numpy:
importing them loads no JAX.  The port reuses them instead of copying
them, so both packages are held to one spec, and this module is the one
place in the port that names them.
"""

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.colorspace import (
    FIXED_COEFFS,
    FIXED_SHIFT,
    LUMA_COEF,
    VECTORSCOPE_TINT,
    Colorspace,
    calc_colorspace,
    quantize_unorm8,
)
from obs_color_monitor_tpu.config import (
    Components,
    DisplayMode,
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    LevelMode,
    VectorscopeConfig,
    WaveformConfig,
    ZebraConfig,
)
from obs_color_monitor_tpu.golden import render as golden_render
from obs_color_monitor_tpu.golden.reference import (
    FALSECOLOR_BANDS,
    falsecolor_band_colors_u8,
    luma_threshold_fixed,
    peaking_threshold_fixed,
)

__all__ = [
    "golden",
    "golden_render",
    "FIXED_COEFFS",
    "FIXED_SHIFT",
    "LUMA_COEF",
    "VECTORSCOPE_TINT",
    "Colorspace",
    "calc_colorspace",
    "quantize_unorm8",
    "Components",
    "DisplayMode",
    "FalseColorConfig",
    "FocusPeakingConfig",
    "HistogramConfig",
    "LevelMode",
    "VectorscopeConfig",
    "WaveformConfig",
    "ZebraConfig",
    "FALSECOLOR_BANDS",
    "falsecolor_band_colors_u8",
    "luma_threshold_fixed",
    "peaking_threshold_fixed",
]
