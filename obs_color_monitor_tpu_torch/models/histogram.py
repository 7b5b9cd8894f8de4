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
from ..ops.stats import apply_channel_select
from .base import (
    FLAG_CONVERT_RGB,
    FLAG_CONVERT_YUV,
    Needs,
    StandaloneScopeMixin,
    StatScope,
    SurfaceData,
)

HI_SIZE = 256


class Histogram(StatScope, StandaloneScopeMixin):
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

    def stat_job(self):
        """The selected counts' hi_max and levels, the render and the
        graticule as one job."""
        if self.config.bypass:
            return None
        v = self._read()
        if v is None:
            return None
        counts, n_pixels = v
        cfg = self.config
        n = cfg.components.n_components
        key = (
            cfg.graticule_vertical_lines, cfg.graticule_horizontal_step, cfg.level_height,
            int(cfg.display), n, cfg.level_fixed, cfg.level_ratio_permille, cfg.logscale,
        )
        overlay = self._device_const(key, lambda: histogram_graticule(*key), counts.device)
        return render_ops.histogram_job(
            counts.to(torch.int32), overlay, cfg.components.channel_select(), n_pixels,
            level_fixed=cfg.level_fixed, level_ratio_permille=cfg.level_ratio_permille,
            logscale=cfg.logscale, level_height=cfg.level_height, display=int(cfg.display),
            n_components=n, yuv_mode=cfg.components.is_yuv)

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
