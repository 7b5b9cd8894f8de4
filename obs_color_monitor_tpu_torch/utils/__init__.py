"""Utilities: host-side rasterization for graticules and legends
(counterpart of ``obs_color_monitor_tpu/utils/__init__.py``, draw only)."""

from .draw import OverlayCanvas, alpha_blend_u8, text_mask

__all__ = ["OverlayCanvas", "alpha_blend_u8", "text_mask"]
