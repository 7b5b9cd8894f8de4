"""Scope base class and the shared capture fan-out hub.

Counterpart of ``obs_color_monitor_tpu/models/base.py`` (``SurfaceData``
``:37``, ``Needs`` ``:65``, ``Scope`` ``:86``, ``CaptureHub`` ``:212``,
``StandaloneScopeMixin`` ``:369``).  Each scope is created with settings,
receives per-frame surfaces through a callback, keeps double-buffered
results and renders on demand (reference src/common.h:95-114; double
buffering e.g. src/vectorscope.c:46-48,264).  The hub replaces the cm
capture core and the ROI hub (reference src/common.c:223-333,
src/roi.c:315-341): one ``ops.fused.analyze`` per frame (kernels K1 and K2
on a card), fanned out to every registered consumer, with the consumers'
needs unioned into analyze's flags.

The JAX scopes split their renders into traced programs so the dock can
fuse them into one XLA program; here a render is a short fixed sequence of
launches, so each scope has one ``render_image``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..api import check_device
from ..colorspace import Colorspace, calc_colorspace
from ..config import CaptureConfig, ROIConfig
from ..ops.convert import (
    _as_device_arg,
    host_packed_view,
    nv12_to_packed,
    planes_to_rgba,
)
from ..ops.fused import AnalysisResult, analyze

_MISS = object()

# Capture flags (reference src/common.h:90-93).
FLAG_CONVERT_RGB = 1
FLAG_CONVERT_YUV = 2
FLAG_RAW_TEXTURE = 4
FLAG_ROI = 8


@dataclasses.dataclass
class SurfaceData:
    """Per-frame analysis handed to scope callbacks: the device-resident
    results of the fused pass plus geometry and colorspace (the
    reference's cm_surface_data carries mapped CPU pointers,
    src/common.h:24-30).  Frame data in ``result`` is planar (C, H, W) u8."""

    result: AnalysisResult
    width: int
    height: int
    colorspace: Colorspace
    # True when ``result.planes`` is the ROI crop: the preview row renders
    # it plainly rather than re-resolving the rect against the crop's dims
    cropped: bool = False
    # Set by the dock's dynamic-rect route (mid-drag frames,
    # models/dock.Dock._consume_dynamic): the (x0, y0, x1, y1) rect the
    # statistics were computed within.  ``result.planes`` is then the full
    # scaled capture (width/height are its dims, cropped=False) and the
    # waveform counts are full-width with the columns outside the rect
    # zero.  None on every other route.
    dynamic_rect: Optional[tuple[int, int, int, int]] = None


@dataclasses.dataclass
class Needs:
    """What a scope wants from the fused pass (analyze's flags)."""

    vs: bool = False
    wv_rgb: bool = False
    wv_yuv: bool = False
    hi_rgb: bool = False
    hi_yuv: bool = False
    rgba: bool = False

    def __or__(self, other: "Needs") -> "Needs":
        return Needs(*(a or b for a, b in zip(dataclasses.astuple(self),
                                               dataclasses.astuple(other))))


class Scope:
    """Base scope: settings, double-buffered results, render on demand."""

    def __init__(self, config: CaptureConfig):
        self.config = config
        self.flags = 0
        # double buffer (reference tex_buf[2] / w_tex_buf flip)
        self._buf: list[Optional[object]] = [None, None]
        self._w_buf = 0
        self._const_cache: dict = {}

    # -- settings -----------------------------------------------------------
    def update(self, **settings) -> None:
        """Apply settings like the reference's ``*_update`` callbacks."""
        for k, v in settings.items():
            if not hasattr(self.config, k):
                raise KeyError(f"{type(self).__name__} has no setting {k!r}")
            try:
                setattr(self.config, k, v)
            except AttributeError as e:
                # read-only derived properties (level_fixed, ...) are not
                # settings; surface them on the same unknown-setting path
                raise KeyError(f"{type(self).__name__} setting {k!r} is read-only") from e
        self.config.__post_init__()

    @property
    def colorspace(self) -> Colorspace:
        return calc_colorspace(self.config.colorspace)

    # -- capture contract ---------------------------------------------------
    def needs(self) -> Needs:
        raise NotImplementedError

    def surface_cb(self, surface: SurfaceData) -> None:
        """Consume one frame's analysis (reference cm_surface_cb_t)."""
        raise NotImplementedError

    def tick(self, seconds: float = 1.0 / 60.0) -> None:
        """Per-display-frame bookkeeping (reference video_tick)."""

    # -- double buffer ------------------------------------------------------
    def _publish(self, value) -> None:
        self._buf[self._w_buf] = value
        self._w_buf ^= 1

    def _read(self):
        return self._buf[self._w_buf ^ 1]

    # -- bypass (reference cm_bypass_render, src/common.c:413-428) ----------
    _bypass_planes = None

    def _store_bypass(self, surface: SurfaceData) -> None:
        if getattr(self.config, "bypass", False) and surface.result.planes is not None:
            self._bypass_planes = surface.result.planes

    def render_bypass(self):
        """The scaled captured frame itself (reference bypass mode), as a
        device RGBA image."""
        return None if self._bypass_planes is None else planes_to_rgba(self._bypass_planes)

    # -- device constants (graticules, key legends) -------------------------
    def _device_const(self, key, build, device):
        """A host-built overlay, constant per config: built once and kept
        on ``device`` (streamed frames do not upload it again)."""
        hit = self._const_cache.get((key, str(device)), _MISS)
        if hit is _MISS:
            v = build()
            hit = None if v is None else torch.as_tensor(np.ascontiguousarray(v), device=device)
            self._const_cache[(key, str(device))] = hit
        return hit

    # -- output -------------------------------------------------------------
    def render_image(self) -> Optional[torch.Tensor]:
        """The device-resident (H, W, 4) u8 image, or None before the first
        frame.  Nothing crosses to the host: the dock composites on the
        device and fetches the panel once."""
        raise NotImplementedError

    def render(self) -> Optional[np.ndarray]:
        """RGBA u8 image of the scope on the host, or None before the first
        frame."""
        img = self.render_image()
        return None if img is None else img.cpu().numpy()

    @property
    def width(self) -> int:
        raise NotImplementedError

    @property
    def height(self) -> int:
        raise NotImplementedError


class CaptureHub:
    """Shared capture and fan-out (reference roi.c / common.c collapsed).

    One hub per capture target, running on ``device``.  Consumers register
    like the reference's ``roi_register_source`` (src/roi.c:315-327); every
    processed frame runs ONE fused analysis and calls every consumer's
    callback with the same SurfaceData (src/roi.c:329-341).  With
    ``interleave=n`` only every (n+1)-th frame is processed (reference
    src/roi.c:266-277,523-532)."""

    def __init__(self, config: Optional[ROIConfig] = None, device="cuda"):
        self.config = config or ROIConfig()
        self.device = torch.device(device)
        self.consumers: list[Scope] = []
        self._i_interleave = 0
        self._rendered = False
        self.last_surface: Optional[SurfaceData] = None
        self.frames_processed = 0
        self.frames_skipped = 0
        # scaled (pre-crop) capture dims of the last processed frame
        self.capture_size: Optional[tuple[int, int]] = None
        # the resolved rect the last processed frame was published under
        self.published_rect: Optional[tuple[int, int, int, int]] = None

    def register(self, scope: Scope) -> None:
        self.consumers.append(scope)

    def unregister(self, scope: Scope) -> None:
        self.consumers.remove(scope)

    @property
    def colorspace(self) -> Colorspace:
        return calc_colorspace(self.config.colorspace)

    def union_needs(self) -> Needs:
        n = Needs()
        for c in self.consumers:
            n = n | c.needs()
        return n

    def tick(self) -> None:
        """Advance the interleave counter (reference src/roi.c:523-532)."""
        if self._rendered:
            self._i_interleave += 1
            if self._i_interleave > self.config.interleave:
                self._i_interleave = 0
        self._rendered = False
        for c in self.consumers:
            c.tick()

    def to_device(self, frame, is_planar: bool = False) -> torch.Tensor:
        """A frame on the hub's device: a host (H, W, 4) u8 frame crosses as
        its (H, W) int32 packed view (the same bytes, one copy), any other
        host array as ``ops.convert._as_device_arg`` makes it; a tensor
        must already be there."""
        if not is_planar:
            frame = host_packed_view(frame)
        frame = _as_device_arg(frame, self.device)
        check_device(frame, self.device)
        return frame

    def process(self, frame, is_planar: bool = False) -> Optional[SurfaceData]:
        """Analyze one frame and fan out; None if interleave-skipped.

        frame: (H, W, 4) u8, (4, H, W) u8 with ``is_planar``, or the (H, W)
        32-bit packed view of the RGBA bytes; a host array or a tensor on
        the hub's device."""
        self._rendered = True
        if self._i_interleave != 0 and self.config.interleave > 0:
            self.frames_skipped += 1
            return None
        frame = self.to_device(frame, is_planar)
        if is_planar or frame.ndim == 2:
            h, w = frame.shape[-2], frame.shape[-1]
        else:
            h, w = frame.shape[-3], frame.shape[-2]
        scale = self.config.target_scale
        sw, sh = w // scale, h // scale
        if sw <= 0 or sh <= 0:
            # smaller than the scale divisor: skip, like the reference
            # (src/common.c:251-254 returns without staging)
            self.frames_skipped += 1
            return None
        rect = self.config.resolve_rect(sw, sh)
        full = rect == (0, 0, sw, sh)
        # the scaled capture before the crop: the space of interactive
        # ROI selection (the dock's mouse bridge reads it)
        self.capture_size = (sw, sh)
        self.published_rect = rect
        needs = self.union_needs()
        cs = self.colorspace
        from ..pipeline import profiler

        with profiler.probe("render_target"):
            result = analyze(
                frame, cs=int(cs), scale=scale, rect=None if full else rect,
                need_vs=needs.vs, need_wv_rgb=needs.wv_rgb, need_wv_yuv=needs.wv_yuv,
                need_hi_rgb=needs.hi_rgb, need_hi_yuv=needs.hi_yuv, is_planar=is_planar,
            )
        surface = SurfaceData(result=result, width=rect[2] - rect[0], height=rect[3] - rect[1],
                              colorspace=cs, cropped=not full)
        self.last_surface = surface
        for c in self.consumers:
            with profiler.probe(f"surface_cb:{type(c).__name__}"):
                c.surface_cb(surface)
        self.frames_processed += 1
        return surface

    def process_nv12(self, y, uv, cs: Optional[int] = None, shift: int = 0):
        """An NV12 frame in: decoded on the device (K4, or K5 for the
        P010 family with ``shift`` > 0) to the packed RGBA view, then the
        :meth:`process` fan-out.  Host planes cross as 1.5 B/px (3 B/px at
        16 bits), in one copy when they are adjacent views of one buffer.
        ``cs`` is the decode colorimetry; it defaults to the hub's analysis
        colorspace."""
        from ..ops.convert import nv12_device_planes  # looked up at the call, as in JAX

        cs_i = int(cs) if cs is not None else int(self.colorspace)
        return self.process(nv12_to_packed(*nv12_device_planes(y, uv, self.device), cs=cs_i,
                                           shift=shift))

    def set_roi(self, x0: int, y0: int, x1: int, y1: int) -> None:
        """Select a sub-rect in scaled coordinates (the reference's
        interactive drag, src/roi.c:343-521, lives in ``roi_interact``)."""
        self.config.x0, self.config.y0 = x0, y0
        self.config.x1, self.config.y1 = x1, y1


class StandaloneScopeMixin:
    """A scope driving its own private hub (the reference's non-ROI path,
    where each cm_source owns a texrender/staging pipeline,
    src/common.c:430-454)."""

    def attach_private_hub(self, capture: CaptureConfig, device=None) -> CaptureHub:
        """A hub of the scope's own, on ``device`` (None: the device of the
        hub the scope has, else "cuda")."""
        if device is None:
            device = self._hub.device if getattr(self, "_hub", None) is not None else "cuda"
        hub = CaptureHub(ROIConfig(target_scale=capture.target_scale,
                                   colorspace=capture.colorspace, interleave=0), device)
        hub.register(self)  # type: ignore[arg-type]
        self._hub = hub
        return hub

    def push_frame(self, frame) -> None:
        self._hub.tick()
        self._hub.process(frame)

    def push_nv12(self, y, uv, cs: Optional[int] = None, shift: int = 0) -> None:
        """NV12 frame in, decoded on the device (CaptureHub.process_nv12)."""
        self._hub.tick()
        self._hub.process_nv12(y, uv, cs=cs, shift=shift)
