"""Waveform scope (reference src/waveform.c).

Counterpart of ``obs_color_monitor_tpu/models/waveform.py``: per-column
256-level intensity map with RGB/Luma/Chroma/YUV component select,
overlay/stack/parade display, horizontal graticule lines.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Components, DisplayMode, WaveformConfig
from ..ops import render as render_ops
from ..ops.graticule import waveform_graticule
from ..ops.stats import apply_channel_select
from .base import (
    FLAG_CONVERT_RGB,
    FLAG_CONVERT_YUV,
    Needs,
    Scope,
    StandaloneScopeMixin,
    SurfaceData,
)

WV_SIZE = 256


class Waveform(Scope, StandaloneScopeMixin):
    def __init__(self, config: Optional[WaveformConfig] = None, device="cuda"):
        config = config or WaveformConfig()
        super().__init__(config)
        self._r_buf = 0  # published on tick (reference wvs_tick, waveform.c:394-400)
        self._buf_width = [0, 0]
        # (x0, x1) columns of valid data when the published buffer is
        # full-width with the columns outside the rect zero (the dock's
        # dynamic-rect publication); None = the buffer is its own rect
        self._buf_rect = [None, None]
        self._update_flags()
        self.attach_private_hub(config, device)

    def _update_flags(self) -> None:
        c = self.config.components
        # reference src/waveform.c:100-102
        self.flags = (FLAG_CONVERT_RGB if (c & Components.RGB) else 0) | (
            FLAG_CONVERT_YUV if c.is_yuv else 0
        )

    def update(self, **settings) -> None:
        super().update(**settings)
        self._update_flags()

    def needs(self) -> Needs:
        yuv = self.config.components.is_yuv
        return Needs(wv_rgb=not yuv, wv_yuv=yuv, rgba=self.config.bypass)

    def surface_cb(self, surface: SurfaceData) -> None:
        self._store_bypass(surface)
        res = surface.result
        counts = res.wv_yuv if self.config.components.is_yuv else res.wv_rgb
        if counts is None:
            return
        # the raw counts: channel selection is a read/render-time concern
        self._buf_width[self._w_buf] = surface.width
        r = surface.dynamic_rect
        self._buf_rect[self._w_buf] = None if r is None else (r[0], r[2])
        self._publish(counts)

    def counts(self) -> Optional[np.ndarray]:
        """Channel-selected u8 counts of the published buffer on the host
        (the reference's dbuf after its zero-first accumulate,
        src/waveform.c:220-257).  A dynamic-rect publication returns its
        rect's columns, so host reads track the live rect."""
        v = self._read()
        if v is None:
            return None
        out = apply_channel_select(v, self.config.components.channel_select()).cpu().numpy()
        rect = self._buf_rect[self._w_buf ^ 1]
        return out if rect is None else out[:, :, rect[0] : rect[1]]

    def tick(self, seconds: float = 1.0 / 60.0) -> None:
        # the read buffer only advances on tick (reference waveform.c:394-400)
        self._r_buf = self._w_buf ^ 1

    def render_image(self):
        if self.config.bypass:
            return self.render_bypass()
        counts = self._buf[self._r_buf]  # the tick-gated read buffer
        if counts is None:
            return None
        n = self.config.components.n_components
        img = render_ops.render_waveform(
            apply_channel_select(counts, self.config.components.channel_select()),
            intensity=self.config.intensity, display=int(self.config.display),
            n_components=n, yuv_mode=self.config.components.is_yuv,
        )
        key = (self.config.graticule_lines, self._buf_width[self._r_buf],
               int(self.config.display), n)
        overlay = self._device_const(key, lambda: waveform_graticule(*key), counts.device)
        if overlay is not None:
            img = render_ops.blend_overlay(img, overlay)
        return img

    @property
    def width(self) -> int:
        rect = self._buf_rect[self._r_buf]
        w = self._buf_width[self._r_buf] if rect is None else rect[1] - rect[0]
        if self.config.display == DisplayMode.PARADE:
            return w * self.config.components.n_components
        return w

    @property
    def height(self) -> int:
        if self.config.display == DisplayMode.STACK:
            return WV_SIZE * self.config.components.n_components
        return WV_SIZE
