"""Overlay scopes: Zebra, FalseColor, FocusPeaking (reference src/zebra.c,
src/focuspeaking.c).

Counterpart of ``obs_color_monitor_tpu/models/overlays.py``: each is a
*source* that captures through a hub (the scaled frame, reference
zbs_render src/zebra.c:599-628), and ``apply_planes`` applies it to a
caller's planes as the reference's filter does (zbf_render
src/zebra.c:630-658).  Each overlay runs as kernel K3
(``ops.fused_overlays``) with its one output switched on; the user-LUT
false colour stays torch ops, as in JAX.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np
import torch

from ..colorspace import calc_colorspace, quantize_unorm8
from ..config import FalseColorConfig, FocusPeakingConfig, ShowKey, ZebraConfig
from ..golden.reference import peaking_threshold_fixed, zebra_tm_advance
from ..ops import render as render_ops
from ..ops.convert import planes_to_rgba
from ..ops.fused_overlays import fused_overlays_planes
from ..ops.graticule import falsecolor_key_overlay, key_canvas_size
from ..ops.overlays import falsecolor_lut_planes
from .base import FLAG_RAW_TEXTURE, Needs, Scope, StandaloneScopeMixin, SurfaceData


def _rgba_of_packed(x: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 packed pixels as (H, W, 4) u8 (the same bytes)."""
    return x.view(torch.uint8).view(x.shape[0], x.shape[1], 4)


class _OverlayScope(Scope, StandaloneScopeMixin):
    """Shared source-flavour plumbing: capture the scaled frame, overlay at
    render time.  ``_which`` is the overlay's output of K3 (0 zebra, 1 false
    colour, 2 focus peaking)."""

    _which = 0

    def __init__(self, config, device="cuda"):
        super().__init__(config)
        self.flags = FLAG_RAW_TEXTURE
        self._size = (0, 0)
        self.attach_private_hub(config, device)

    def needs(self) -> Needs:
        return Needs(rgba=True)

    def surface_cb(self, surface: SurfaceData) -> None:
        if surface.result.planes is None:
            return
        self._size = (surface.width, surface.height)
        self._publish((surface.result.planes, surface.colorspace))

    def _k3_args(self, cs) -> dict:
        """K3's arguments for this overlay; the others' are placeholders."""
        return dict(th_low=0.75, th_high=1.0, zb_cs=int(cs), fc_cs=int(cs), peak_th=0,
                    peak_rgba=(0, 0, 0, 0))

    def _k3(self, planes, cs=None, packed_out=False):
        """This overlay of (4, H, W) u8 planes through K3, in the scope's own
        colorspace unless ``cs`` is given (reference zbs_render uses
        src->cm.colorspace even when ROI-fed, src/zebra.c:620)."""
        cs = calc_colorspace(self.config.colorspace if cs is None else cs)
        outputs = tuple(i == self._which for i in range(3))
        return fused_overlays_planes(planes.contiguous(), getattr(self, "tm", 0.0),
                                     packed_out=packed_out, outputs=outputs,
                                     **self._k3_args(cs))[self._which]

    def apply_planes(self, planes, cs=None):
        """Filter flavour on planes: (4, H, W) u8 in, (4, H, W) u8 out."""
        return self._k3(planes, cs)

    def render_image(self):
        v = self._read()
        if v is None:
            return None
        return _rgba_of_packed(self._k3(v[0], packed_out=True))

    @property
    def width(self) -> int:
        return self._size[0]

    @property
    def height(self) -> int:
        return self._size[1]


class Zebra(_OverlayScope):
    """Luma-threshold stripe overlay with an animated clock (reference
    src/zebra.c:660-666)."""

    _which = 0

    def __init__(self, config: Optional[ZebraConfig] = None, device="cuda"):
        super().__init__(config or ZebraConfig(), device)
        self.tm = 0.0

    def tick(self, seconds: float = 1.0 / 60.0) -> None:
        self.tm = zebra_tm_advance(self.tm, seconds)

    def _k3_args(self, cs) -> dict:
        return dict(super()._k3_args(cs), th_low=self.config.th_low, th_high=self.config.th_high)


class FalseColor(_OverlayScope):
    """12-band or LUT luma mapping and an optional key legend (reference
    src/zebra.c with is_falsecolor, key at src/zebra.c:385-597)."""

    _which = 1

    def __init__(self, config: Optional[FalseColorConfig] = None, device="cuda"):
        super().__init__(config or FalseColorConfig(), device)

    @staticmethod
    def lut_fingerprint(lut) -> tuple:
        """Content identity of a LUT (an in-place edit must not hit a cache)."""
        a = np.asarray(lut)
        return (a.shape, a.dtype.str, zlib.crc32(a.tobytes()))

    def apply_planes(self, planes, cs=None):
        cfg = self.config
        cs = calc_colorspace(cfg.colorspace if cs is None else cs)
        if cfg.use_lut and cfg.lut is not None:
            lut = self._device_const(("lut", self.lut_fingerprint(cfg.lut)),
                                     lambda: np.asarray(cfg.lut), planes.device)
            out = falsecolor_lut_planes(planes, lut, cs=int(cs), lut_n=cfg.lut.shape[0])
        else:
            out = self._k3(planes, cs)
        if cfg.show_key != ShowKey.NONE:
            h, w = planes.shape[-2], planes.shape[-1]
            lut = cfg.lut if cfg.use_lut else None
            key_id = (int(cfg.show_key), w, h, int(cs),
                      None if lut is None else self.lut_fingerprint(lut))
            key = self._device_const(
                key_id, lambda: np.moveaxis(falsecolor_key_overlay(cfg.show_key, w, h, cs,
                                                                   lut=lut), -1, 0),
                planes.device)
            ow, oh = key_canvas_size(cfg.show_key, w, h)
            if (oh, ow) != (h, w):
                canvas = torch.zeros((4, oh, ow), dtype=torch.uint8, device=planes.device)
                canvas[3] = 255
                canvas[:, :h, :w] = out
                out = canvas
            out = render_ops.blend_overlay_planes(out, key)
        return out

    def render_image(self):
        cfg = self.config
        if (cfg.use_lut and cfg.lut is not None) or cfg.show_key != ShowKey.NONE:
            v = self._read()
            return None if v is None else planes_to_rgba(self.apply_planes(v[0]))
        return super().render_image()

    @property
    def width(self) -> int:
        w, h = self._size
        return key_canvas_size(self.config.show_key, w, h)[0]

    @property
    def height(self) -> int:
        w, h = self._size
        return key_canvas_size(self.config.show_key, w, h)[1]


class FocusPeaking(_OverlayScope):
    """4-neighbour edge highlight (reference src/focuspeaking.c)."""

    _which = 2

    def __init__(self, config: Optional[FocusPeakingConfig] = None, device="cuda"):
        super().__init__(config or FocusPeakingConfig(), device)

    def _k3_args(self, cs) -> dict:
        cfg = self.config
        rgba = tuple(int(c) for c in quantize_unorm8(np.asarray(cfg.peaking_rgba, np.float32)))
        return dict(super()._k3_args(cs), peak_th=peaking_threshold_fixed(cfg.peaking_threshold),
                    peak_rgba=rgba)
