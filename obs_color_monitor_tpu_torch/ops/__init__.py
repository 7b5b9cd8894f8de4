"""Device ops of the torch port (counterpart of ``obs_color_monitor_tpu/ops``).

Plain torch: ``convert``, ``overlays``, ``stats``; numpy: ``graticule``.
Kernel wrappers with their plain versions beside them: ``pipeline`` (K1,
the whole-frame pass), ``scope_stats`` (K2, vectorscope + waveform, either
alone), ``fused_overlays`` (K3, the three overlays), ``decode`` (K4/K5,
NV12/P010 decode), ``render`` (KR, ``draw_stat_images``: the stats scopes'
images, beside their torch renders) and ``compose`` (the dock panel's
layout and assembly for ``dock_step`` and the Dock; KC, the dynamic-ROI
panel in one launch).  ``fused.analyze`` runs K1 + K2.
The package re-exports the JAX ``ops`` package's names
(``ops/__init__.py:7-53``): the planar forms and their interleaved boundary
wrappers.  Importing this package imports no kernel toolchain; kernels
build at their first CUDA launch.
"""

from .convert import (
    downscale,
    downscale_planes,
    interleave,
    luma_fixed,
    luma_planes,
    nv12_shift,
    nv12_to_packed,
    nv12_to_planes,
    planarize,
    rgb_to_yuv_planes,
    rgb_to_yuv_u8,
    roi_crop,
    roi_crop_planes,
)
from .stats import (
    apply_channel_select,
    histogram_counts,
    histogram_hi_max,
    histogram_levels,
    select_planes,
    vectorscope_counts,
    waveform_counts,
)

__all__ = [
    "planarize",
    "interleave",
    "rgb_to_yuv_u8",
    "rgb_to_yuv_planes",
    "luma_fixed",
    "luma_planes",
    "downscale",
    "downscale_planes",
    "roi_crop",
    "roi_crop_planes",
    "nv12_shift",
    "nv12_to_planes",
    "nv12_to_packed",
    "histogram_counts",
    "histogram_hi_max",
    "histogram_levels",
    "vectorscope_counts",
    "waveform_counts",
    "select_planes",
    "apply_channel_select",
]
