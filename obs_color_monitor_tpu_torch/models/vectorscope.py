"""Vectorscope scope (reference src/vectorscope.c).

Counterpart of ``obs_color_monitor_tpu/models/vectorscope.py``: 256x256
CbCr occupancy with u8 saturating counters, intensity-scaled draw with
white/chroma tint, graticule (target boxes, labels, IQ/skin-tone lines),
mouse-wheel zoom.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import VectorscopeColorType, VectorscopeConfig
from ..ops import render as render_ops
from ..ops.graticule import vectorscope_graticule
from .base import FLAG_CONVERT_YUV, Needs, StandaloneScopeMixin, StatScope, SurfaceData

VS_SIZE = 256


class Vectorscope(StatScope, StandaloneScopeMixin):
    def __init__(self, config: Optional[VectorscopeConfig] = None, device="cuda"):
        config = config or VectorscopeConfig()
        super().__init__(config)
        self.flags = FLAG_CONVERT_YUV  # reference src/vectorscope.c:77
        self._buf_cs = [None, None]  # tex_cs double buffer (vectorscope.c:45)
        self.attach_private_hub(config, device)

    def needs(self) -> Needs:
        return Needs(vs=True, rgba=self.config.bypass)

    def surface_cb(self, surface: SurfaceData) -> None:
        self._store_bypass(surface)
        if surface.result.vs_counts is None:
            return
        self._buf_cs[self._w_buf] = surface.colorspace
        self._publish(surface.result.vs_counts)

    def zoom_by(self, wheel_delta: float) -> None:
        """Mouse-wheel zoom (reference src/vectorscope.c:473-482)."""
        self.config.zoom = max(1.0, self.config.zoom * float(np.exp(wheel_delta * 5e-4)))

    def stat_job(self):
        """The render, the graticule and the zoom as one job."""
        if self.config.bypass:
            return None
        counts = self._read()
        if counts is None:
            return None
        cs = int(self._buf_cs[self._w_buf ^ 1])
        key = (int(self.config.graticule), self.config.graticule_skintone_color, cs)
        overlay = self._device_const(key, lambda: vectorscope_graticule(*key), counts.device)
        return render_ops.vectorscope_job(
            counts, overlay, intensity=self.config.intensity, cs=cs,
            white=self.config.color_type == VectorscopeColorType.WHITE,
            zoom=round(self.config.zoom, 3))

    @property
    def width(self) -> int:
        return VS_SIZE

    @property
    def height(self) -> int:
        return VS_SIZE
