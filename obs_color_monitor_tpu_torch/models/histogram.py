"""Histogram scope (reference src/histogram.c).

Counterpart of ``obs_color_monitor_tpu/models/histogram.py``: 256-bin
per-channel counts with auto/pixels/ratio level modes, optional log scale,
overlay/stack/parade bar rendering, V/H graticules.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Components, DisplayMode, HistogramConfig
from ..ops import render as render_ops
from ..ops.graticule import histogram_graticule
from ..ops.stats import apply_channel_select, histogram_hi_max, histogram_levels
from .base import (
    FLAG_CONVERT_RGB,
    FLAG_CONVERT_YUV,
    Needs,
    Scope,
    StandaloneScopeMixin,
    SurfaceData,
)

HI_SIZE = 256


class Histogram(Scope, StandaloneScopeMixin):
    def __init__(self, config: Optional[HistogramConfig] = None, device="cuda"):
        config = config or HistogramConfig()
        super().__init__(config)
        self._update_flags()
        self.attach_private_hub(config, device)

    def _update_flags(self) -> None:
        c = self.config.components
        self.flags = (FLAG_CONVERT_RGB if (c & Components.RGB) else 0) | (
            FLAG_CONVERT_YUV if c.is_yuv else 0
        )

    def update(self, **settings) -> None:
        super().update(**settings)
        self._update_flags()

    def needs(self) -> Needs:
        yuv = self.config.components.is_yuv
        return Needs(hi_rgb=not yuv, hi_yuv=yuv, rgba=self.config.bypass)

    def surface_cb(self, surface: SurfaceData) -> None:
        self._store_bypass(surface)
        res = surface.result
        counts = res.hi_yuv if self.config.components.is_yuv else res.hi_rgb
        if counts is None:
            return
        # the raw counts and their pixel count (a dynamic rect's own):
        # selection, hi_max and the levels come at render time (reference
        # CPU callback work, src/histogram.c:396-418)
        r = surface.dynamic_rect
        n_px = surface.width * surface.height if r is None else (r[2] - r[0]) * (r[3] - r[1])
        self._publish((counts, n_px))

    def counts(self) -> Optional[np.ndarray]:
        """Channel-selected u32 bin counts of the published buffer on the
        host (the reference's dbuf, src/histogram.c:357-395)."""
        v = self._read()
        if v is None:
            return None
        sel = self.config.components.channel_select()
        return apply_channel_select(v[0], sel).cpu().numpy().astype(np.uint32)

    def render_image(self):
        if self.config.bypass:
            return self.render_bypass()
        v = self._read()
        if v is None:
            return None
        counts, n_pixels = v
        sel = self.config.components.channel_select()
        counts = apply_channel_select(counts, sel).to(torch.int32)
        hi = histogram_hi_max(counts, sel, n_pixels, self.config.level_fixed,
                              self.config.level_ratio_permille)
        levels, hi_eff = histogram_levels(counts, hi, sel, self.config.logscale)
        n = self.config.components.n_components
        img = render_ops.render_histogram(
            levels, hi_eff, level_height=self.config.level_height,
            display=int(self.config.display), n_components=n,
            yuv_mode=self.config.components.is_yuv,
        )
        key = (
            self.config.graticule_vertical_lines, self.config.graticule_horizontal_step,
            self.config.level_height, int(self.config.display), n, self.config.level_fixed,
            self.config.level_ratio_permille, self.config.logscale,
        )
        overlay = self._device_const(key, lambda: histogram_graticule(*key), counts.device)
        if overlay is not None:
            img = render_ops.blend_overlay(img, overlay)
        return img

    @property
    def width(self) -> int:
        if self.config.display == DisplayMode.PARADE:
            return HI_SIZE * self.config.components.n_components
        return HI_SIZE

    @property
    def height(self) -> int:
        if self.config.display == DisplayMode.STACK:
            return self.config.level_height * self.config.components.n_components
        return self.config.level_height
