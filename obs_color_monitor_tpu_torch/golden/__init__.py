"""NumPy golden model (test oracle) for all scope statistics and overlays.

Copied whole from ``obs_color_monitor_tpu/golden/__init__.py``."""

from .reference import (
    VS_SIZE,
    WV_SIZE,
    HI_SIZE,
    rgb_to_yuv_u8,
    downscale,
    roi_crop,
    vectorscope_counts,
    waveform_counts,
    histogram_counts,
    histogram_hi_max,
    histogram_levels,
    zebra,
    falsecolor,
    falsecolor_band_index,
    falsecolor_band_colors_u8,
    focus_peaking,
    zebra_tm_advance,
    FALSECOLOR_BANDS,
)

__all__ = [
    "VS_SIZE",
    "WV_SIZE",
    "HI_SIZE",
    "rgb_to_yuv_u8",
    "downscale",
    "roi_crop",
    "vectorscope_counts",
    "waveform_counts",
    "histogram_counts",
    "histogram_hi_max",
    "histogram_levels",
    "zebra",
    "falsecolor",
    "falsecolor_band_index",
    "falsecolor_band_colors_u8",
    "focus_peaking",
    "zebra_tm_advance",
    "FALSECOLOR_BANDS",
]
