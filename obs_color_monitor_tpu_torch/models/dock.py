"""Composite "dock" view: all scopes off one shared capture
(reference src/scope-widget.cpp).

Counterpart of ``obs_color_monitor_tpu/models/dock.py`` (``_shaded_preview``
``:114``, ``_RoiPreview`` ``:150``, ``Dock`` ``:214-1178``).  The reference
dock creates an ROI source plus six scopes that all target it
(src/scope-widget.cpp:19-25,542-561) and stacks the shown ones vertically
with per-scope aspect rules (src/scope-widget.cpp:99-175).  Here the Dock
owns a CaptureHub with the six scopes registered; ``render`` composites the
shown ones on the device and fetches the panel once.

The JAX Dock caches XLA programs (a fused render, a one-program stream
step per layout, the dock step) because each program execution costs a
dispatch round trip.  Here the streaming Dock replays CUDA graphs
(``graphs.CapturedStep``): a settled rect replays the stream step, the
analysis, the shown scopes' renders and the composite captured once per
layout, frame shape, configs and rect (``models/dock.py:773-848``); a rect
that moves (a drag, or a rect just changed) replays the captured
dynamic-ROI dock step, which serves every rect with one graph.  Host work
stays outside the graphs: interleave, the frame counters, the mouse
routing and the publication of each frame's results to the scopes, as
fresh tensors.  What a caller can observe is kept: which frame's
statistics a scope read shows after a push, a flush or a render, the
frame counters, interleave, bypass, the mouse routing and the mid-drag
publication.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import (
    DockConfig,
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    ROIConfig,
    VectorscopeConfig,
    WaveformConfig,
    ZebraConfig,
    config_key,
)
from ..dock_step import SCOPE_ORDER, _resize_nearest_rgba, compose_vstack, make_dock_step
from ..dock_step import shaded_preview as _shaded_preview
from ..graphs import captured
from ..ops.convert import (
    OPAQUE_BLACK,
    host_packed_view,
    nv12_to_packed,
    planes_to_rgba,
)
from ..ops.fused import AnalysisResult, analyze
from .base import CaptureHub, Needs, Scope, SurfaceData
from .histogram import Histogram
from .overlays import FalseColor, FocusPeaking, Zebra, shared_overlay_images
from .roi_interact import DRAG_FIRST, DRAG_MOVE, DRAG_RESIZE, InteractiveROI
from .vectorscope import Vectorscope
from .waveform import Waveform

__all__ = ["Dock", "SCOPE_ORDER"]


class _NV12Pending(NamedTuple):
    """A deferred NV12 frame: its (y, uv) planes, already on the device,
    and the decode colorimetry; ``shift`` > 0 marks P010-family u16
    planes."""

    y: torch.Tensor
    uv: torch.Tensor
    cs: int
    shift: int = 0


# the reference draws up to 4 border edges + 4 handles x 3 lines each
_MAX_INDICATOR_SEGS = 16
_GREEN = (0, 255, 0, 255)


def _segments_px(panel: torch.Tensor, segs) -> torch.Tensor:
    """1-px green axis-aligned line segments at panel coordinates, the
    drag/hover indicator of the reference's draw_roi_rect
    (src/roi.c:183-242), drawn over the finished panel.  ``segs`` are host
    (x0, y0, x1, y1) inclusive spans, x0 <= x1 and y0 <= y1."""
    panel = panel.clone()
    for x0, y0, x1, y1 in segs:
        region = panel[y0 : y1 + 1, x0 : x1 + 1]
        for c, v in enumerate(_GREEN):
            region[..., c] = v
    return panel


class _RoiPreview(Scope):
    """The dock's row 0: the captured frame itself (the ROI source's own
    render, reference src/roi.c:279-315)."""

    def __init__(self, hub: CaptureHub):
        super().__init__(hub.config)
        self._hub = hub
        self._size = (0, 0)
        # whether each published buffer is an ROI crop (paired with _buf)
        self._buf_cropped = [False, False]

    def needs(self):
        return Needs(rgba=True)

    def surface_cb(self, surface) -> None:
        if surface.result.planes is not None:
            self._size = (surface.width, surface.height)
            self._buf_cropped[self._w_buf] = surface.cropped
            self._publish(surface.result.planes)

    def render_image(self):
        v = self._read()
        if v is None:
            return None
        h, w = v.shape[-2], v.shape[-1]
        rect = self._hub.config.resolve_rect(w, h)
        if self._buf_cropped[self._w_buf ^ 1] or rect == (0, 0, w, h):
            # the crop itself (shading it against its own dims would shade
            # it twice), or the full frame
            return planes_to_rgba(v)
        return _shaded_preview(v, rect)

    @property
    def width(self) -> int:
        return self._size[0]

    @property
    def height(self) -> int:
        return self._size[1]


class Dock:
    """Shared capture + all six scopes (shown per config; default = ROI
    preview + five, reference new-dock) + vertical-stack compositor, on
    ``device``."""

    def __init__(
        self,
        config: Optional[DockConfig] = None,
        roi: Optional[ROIConfig] = None,
        vectorscope: Optional[VectorscopeConfig] = None,
        waveform: Optional[WaveformConfig] = None,
        histogram: Optional[HistogramConfig] = None,
        zebra: Optional[ZebraConfig] = None,
        falsecolor: Optional[FalseColorConfig] = None,
        focuspeaking: Optional[FocusPeakingConfig] = None,
        *,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.config = config or DockConfig()
        self.hub = CaptureHub(roi or ROIConfig(), self.device)
        # the scopes share the hub: their private hubs are left unused
        self.vectorscope = Vectorscope(vectorscope, self.device)
        self.waveform = Waveform(waveform, self.device)
        self.histogram = Histogram(histogram, self.device)
        self.zebra = Zebra(zebra, self.device)
        self.falsecolor = FalseColor(falsecolor, self.device)
        self.focuspeaking = FocusPeaking(focuspeaking, self.device)
        self.roi_preview = _RoiPreview(self.hub)
        self.scopes: dict[str, Scope] = {
            "roi": self.roi_preview,
            "vectorscope": self.vectorscope,
            "waveform": self.waveform,
            "histogram": self.histogram,
            "zebra": self.zebra,
            "falsecolor": self.falsecolor,
            "focuspeaking": self.focuspeaking,
        }
        self.hub.consumers = [self.scopes[k] for k in SCOPE_ORDER]
        # per-scope display rects of the last render, for mouse routing:
        # name -> (x0, y0, w, h, w_src, h_src) (reference
        # src/scope-widget.cpp:146-153,241-428)
        self._rects: dict[str, tuple[int, int, int, int, int, int]] = {}
        # a render has shown every shown scope with published data: from
        # then on push/render alternation defers the analysis into render
        self._warm = False
        self._pending = None  # frame pushed but not yet analyzed
        self._rendered_since_push = True
        self.roi_interact: Optional[InteractiveROI] = None
        # the last streamed rect: a change routes the frame onto the
        # dynamic-ROI step until the rect settles
        self._last_stream_rect = None
        # whether the last-rendered roi band displays the crop, and that
        # crop's capture-space origin, snapshotted at render time: the mouse
        # bridge translates with these (a move-drag changes the committed
        # rect between renders; a live offset would compound into drift)
        self._roi_shows_crop = False
        self._roi_crop_origin = (0, 0)
        # the rect under which the published scope buffers were produced
        self._leaves_rect = None
        self._device_step = None
        self._device_step_key = None
        # the captured stream step of the settled route and its key
        self._settled = None
        self._settled_key = None

    def shown(self, name: str) -> bool:
        return bool(getattr(self.config, f"show_{name}"))

    def _stream_ok(self) -> bool:
        """Push/render alternation defers the analysis into the render once
        a render has shown every scope, with exactly the default consumers
        (a custom consumer's surface_cb must see every processed frame) and
        no bypass (``models/dock.py:289-304``)."""
        if not self._warm or self.hub.consumers != [self.scopes[k] for k in SCOPE_ORDER]:
            return False
        return not any(getattr(self.scopes[k].config, "bypass", False) for k in SCOPE_ORDER)

    def push_frame(self, frame) -> None:
        """One video frame in: tick, shared analysis, fan-out.

        Once streaming (push/render alternation with the default
        consumers), the analysis is deferred into the next render, so
        between ``push_frame(f)`` and that render the scope reads
        (``histogram.counts()``, ``hub.last_surface``, the frame counters)
        still show the previous frame; :meth:`flush` publishes ``f`` at
        once.  A frame pushed without a render in between is analyzed
        through the hub first."""
        self.flush()
        rendered = self._rendered_since_push
        self._rendered_since_push = False
        self.hub.tick()
        if rendered and self._stream_ok():
            self._pending = frame
        elif self.hub.process(frame) is not None:
            self._leaves_rect = self.hub.published_rect

    def push_nv12(self, y, uv, cs: Optional[int] = None, shift: int = 0) -> None:
        """An NV12 frame in: its planes cross to the device as they are (in
        one copy when adjacent, 1.5 B/px) and decode there (K4; K5 for the
        P010 family with ``shift`` > 0).  ``cs`` is the decode colorimetry
        (default: the hub's analysis colorspace)."""
        cs_i = int(cs) if cs is not None else int(self.hub.colorspace)
        self.flush()
        rendered = self._rendered_since_push
        self._rendered_since_push = False
        self.hub.tick()
        # looked up at the call, as JAX's push_nv12 does: a patched
        # ops.convert.nv12_device_planes sees every upload
        from ..ops.convert import nv12_device_planes

        pending = _NV12Pending(*nv12_device_planes(y, uv, self.device), cs_i, int(shift))
        if rendered and self._stream_ok():
            self._pending = pending
        elif self._hub_process(pending) is not None:
            self._leaves_rect = self.hub.published_rect

    def _hub_process(self, frame):
        """hub.process, decoding a deferred NV12 frame on the device."""
        if isinstance(frame, _NV12Pending):
            return self.hub.process_nv12(frame.y, frame.uv, cs=frame.cs, shift=frame.shift)
        return self.hub.process(frame)

    def flush(self) -> None:
        """Analyze a deferred frame now through the hub fan-out, so scope
        reads show the latest pushed frame without a render."""
        if self._pending is not None:
            f, self._pending = self._pending, None
            if self._hub_process(f) is not None:
                self._leaves_rect = self.hub.published_rect

    def render(self, width: Optional[int] = None, height: Optional[int] = None) -> np.ndarray:
        """The panel on the host: :meth:`render_async` and one copy."""
        return self.render_async(width, height).cpu().numpy()

    def render_async(self, width: Optional[int] = None, height: Optional[int] = None):
        """Composite the shown scopes (reference draw,
        src/scope-widget.cpp:99-175): vertical stack, each scope centred;
        the vectorscope square; ROI/zebra/falsecolor/focuspeaking keep
        their aspect; waveform/histogram stretch.  Returns the (height,
        width, 4) u8 panel on the device.

        While an ROI drag or hover is in progress, the selection outline is
        drawn over the panel (reference draw_roi_rect, src/roi.c:236-265);
        a rect that moves is served by the dynamic-ROI step."""
        panel = self._render_async_impl(width, height)
        ri = self.roi_interact
        band = self._rects.get("roi")
        segs = [] if ri is None else ri.indicator_segments()
        if not segs or band is None:
            return panel
        x0b, y0b, wb, hb, ws, hs = band
        # segments are in scaled-capture coordinates; when the band shows
        # the crop, shift by the displayed crop's origin first
        ox, oy = self._roi_crop_origin
        mx = lambda v: x0b + (v - ox) * wb // max(ws, 1)
        my = lambda v: y0b + (v - oy) * hb // max(hs, 1)
        drawn = []
        for ax, ay, bx, by in segs[:_MAX_INDICATOR_SEGS]:
            # clip to the band: a segment partly off the view keeps its
            # visible part, one wholly off it is dropped
            sx0, sy0 = max(mx(min(ax, bx)), x0b), max(my(min(ay, by)), y0b)
            sx1, sy1 = min(mx(max(ax, bx)), x0b + wb - 1), min(my(max(ay, by)), y0b + hb - 1)
            if sx0 <= sx1 and sy0 <= sy1:
                drawn.append((sx0, sy0, sx1, sy1))
        return _segments_px(panel, drawn)

    def _render_async_impl(self, width, height):
        cx = width or self.config.width
        cy = height or self.config.height
        self._rendered_since_push = True
        shown = [n for n in SCOPE_ORDER if self.shown(n)]
        if self._pending is not None:
            panel = self._consume_stream(cx, cy, shown)
            if panel is not None:
                return panel
            # the frame was processed or skipped: render the published buffers
        self._set_roi_view()
        panel, self._rects, all_shown = self._composite(cx, cy, shown)
        if all_shown and not any(getattr(self.scopes[n].config, "bypass", False)
                                 for n in shown):
            self._warm = True
        return panel

    def _composite(self, cx: int, cy: int, shown: list):
        """The shown scopes' renders of the published buffers, composited:
        (panel, {name: its display rect}, whether every shown scope had
        data).  Device work only: it reads the scopes' state and changes
        none (the settled route captures it)."""
        rects = {}
        patches = []
        all_shown = True
        y0 = 0
        # the overlay scopes on the same planes take one K3 launch together
        shared = shared_overlay_images([self.scopes[n] for n in shown])
        for k, name in enumerate(shown):
            scope = self.scopes[name]
            img = shared[scope] if scope in shared else scope.render_image()
            h_slot = (cy - y0) // (len(shown) - k)
            if img is None:
                all_shown = False
                y0 += h_slot
                continue
            h_src, w_src = int(img.shape[0]), int(img.shape[1])
            w, h = cx, h_slot
            actual = self.focuspeaking.config.actual_size
            keep_aspect = name in ("roi", "zebra", "falsecolor") or (
                name == "focuspeaking" and not actual)
            if name == "vectorscope":
                w = h = min(w, h)
            elif keep_aspect and w_src > 0 and h_src > 0:
                if w * h_src > h * w_src:
                    w = h * w_src // h_src
                elif h * w_src > w * h_src:
                    h = w * h_src // w_src
            crop = None
            if name == "focuspeaking" and actual and w_src > 0:
                # 1:1 pixels, centred, cropped to the slot (reference
                # set_actual_size_matrix, focuspeaking.c:203-220)
                w, h = min(w, w_src), min(h, h_src)
                crop = ((h_src - h) // 2, (w_src - w) // 2)
            if w > 0 and h > 0:
                x0 = (cx - w) // 2
                if crop is None:
                    patch = _resize_nearest_rgba(img, h, w)
                else:
                    patch = img[crop[0] : crop[0] + h, crop[1] : crop[1] + w]
                patches.append((x0, y0, patch))
                rects[name] = (x0, y0, w, h, w_src, h_src)
            y0 += h_slot
        if not patches:
            black = torch.full((cy, cx), OPAQUE_BLACK, dtype=torch.int32, device=self.device)
            return black.view(torch.uint8).view(cy, cx, 4), rects, all_shown
        return compose_vstack(patches, cx, cy), rects, all_shown

    def _frame_dims(self, frame) -> tuple[int, int]:
        """(h, w) of a pending frame: NV12, packed (H, W) or (H, W, 4)."""
        if isinstance(frame, _NV12Pending):
            return frame.y.shape[-2], frame.y.shape[-1]
        frame = host_packed_view(frame)
        if frame.ndim == 2:
            return frame.shape[-2], frame.shape[-1]
        return frame.shape[-3], frame.shape[-2]

    def _consume_stream(self, cx: int, cy: int, shown: list):
        """The deferred frame of a streaming render: interleave, then either
        the dynamic-ROI step (the rect is moving) or the settled route's
        captured stream step (``models/dock.py:597-771``), which gives the
        panel and publication of the hub fan-out.  Returns the panel, or
        None when the caller renders the published buffers (a skipped
        frame, or one processed by the hub fan-out: the published buffers
        belong to another rect, or the waveform has no published frame)."""
        frame, self._pending = self._pending, None
        hub = self.hub
        hub._rendered = True
        if hub._i_interleave != 0 and hub.config.interleave > 0:
            hub.frames_skipped += 1
            return None  # skipped: the panel re-renders the published buffers
        h, w = self._frame_dims(frame)
        scale = hub.config.target_scale
        sw, sh = w // scale, h // scale
        if sw <= 0 or sh <= 0:
            hub.frames_skipped += 1
            return None
        hub.capture_size = (sw, sh)
        rect = hub.config.resolve_rect(sw, sh)
        moving = rect != (0, 0, sw, sh) and (
            self._roi_dragging()
            or (self._last_stream_rect is not None and self._last_stream_rect != rect))
        self._last_stream_rect = rect
        if moving:
            return self._consume_dynamic(frame, cx, cy, rect)
        wv = self.waveform
        if self._leaves_rect == rect and wv._buf[wv._r_buf] is not None:
            return self._consume_settled(frame, cx, cy, shown, rect)
        # the published buffers belong to another rect (a just-settled drag
        # published full-capture ones) or the waveform's read buffer is
        # empty: one fan-out frame republishes every scope at this rect
        self._hub_process(frame)
        self._leaves_rect = rect
        return None

    def _consume_settled(self, frame, cx: int, cy: int, shown: list, rect):
        """A settled frame through the captured stream step: analysis, the
        shown scopes' renders of that analysis and the composite replayed as
        one graph (captured once per layout, frame shape, configs, rect and
        the waveform's read buffer), then the analysis published to every
        consumer as the hub fan-out publishes it, in fresh tensors.  The
        waveform shows the frame before (its tick-gated read buffer, a graph
        input), as on the fan-out route."""
        hub = self.hub
        wv = self.waveform
        sw, sh = hub.capture_size
        full = rect == (0, 0, sw, sh)
        nv12 = isinstance(frame, _NV12Pending)
        arg = (frame.y, frame.uv) if nv12 else hub.to_device(frame)
        key = (cx, cy, tuple(shown), rect, (sw, sh), hub.config.target_scale,
               int(hub.colorspace), (frame.cs, frame.shift) if nv12 else None,
               self._device_confkey(True), wv._buf_width[wv._r_buf], wv._buf_rect[wv._r_buf])
        if key != self._settled_key:
            self._settled = self._settled_step(cx, cy, shown, rect, full, frame)
            self._settled_key = key
        panel, result = self._settled(arg, float(self.zebra.tm), wv._buf[wv._r_buf])
        surface = SurfaceData(result=result, width=rect[2] - rect[0], height=rect[3] - rect[1],
                              colorspace=hub.colorspace, cropped=not full)
        hub.published_rect = rect
        hub.last_surface = surface
        for c in hub.consumers:
            c.surface_cb(surface)
        hub.frames_processed += 1
        self._leaves_rect = rect
        self._set_roi_view()
        self._rects = dict(self._settled.rects)
        return panel

    def _settled_step(self, cx: int, cy: int, shown: list, rect, full: bool, frame):
        """The settled route's stream step, ``(frame, tm, wv_prev) ->
        (panel, AnalysisResult)``, captured on a card: the hub's analysis
        (K4/K5, K1, K2), every consumer's surface_cb on it, the shown
        scopes' renders (one K3 launch for the overlays) and the
        composite.  The scopes' buffers and the Zebra's clock are set for
        the renders and restored after, so only the returned tensors carry
        the frame out (``models/dock.py:773-848`` replays the same code at
        trace time)."""
        hub = self.hub
        consumers = list(hub.consumers)
        needs = hub.union_needs()
        cs = hub.colorspace
        scale = hub.config.target_scale
        wv, zebra = self.waveform, self.zebra
        surface_dims = dict(width=rect[2] - rect[0], height=rect[3] - rect[1])
        decode = None
        if isinstance(frame, _NV12Pending):
            decode = dict(cs=frame.cs, shift=frame.shift)

        def settled(x, tm, wv_prev):
            if decode is not None:
                x = nv12_to_packed(x[0], x[1], **decode)
            res = analyze(x, cs=int(cs), scale=scale, rect=None if full else rect,
                          need_vs=needs.vs, need_wv_rgb=needs.wv_rgb, need_wv_yuv=needs.wv_yuv,
                          need_hi_rgb=needs.hi_rgb, need_hi_yuv=needs.hi_yuv)
            surface = SurfaceData(result=res, colorspace=cs, cropped=not full, **surface_dims)
            saved = [(c, list(c._buf), c._w_buf) for c in consumers]
            clock = zebra.tm
            try:
                for c in consumers:
                    c.surface_cb(surface)
                wv._buf[wv._r_buf] = wv_prev  # the tick-gated read buffer
                zebra.tm = tm
                panel, rects, _ = self._composite(cx, cy, shown)
            finally:
                for c, buf, w_buf in saved:
                    c._buf, c._w_buf = buf, w_buf
                zebra.tm = clock
            step.rects = rects
            return panel, res

        step = captured(settled, self.device, max_graphs=1)
        return step

    def _consume_dynamic(self, frame, cx: int, cy: int, rect):
        """A mid-drag or just-changed-rect frame through the dynamic-ROI
        dock step (``make_dock_step(dynamic_roi=True)``): the same launches
        for every rect (``models/dock.py:850-924``).

        The panel follows the dynamic step (the preview row shows the full
        capture with the selection shaded; the overlay slots fit the rect
        inside static bands).  Every consumer is published fresh, as the
        reference pushes the changed crop to all consumers every tick
        (roi_send_range, src/roi.c:478-520), in the dynamic representation
        (``SurfaceData.dynamic_rect``): exact rect statistics for the
        vectorscope and histogram, full-width waveform counts whose rect
        slice is exact, and the full scaled capture as the preview and
        overlay planes.  Statistics scopes hidden in the dock keep their
        last publication."""
        hub = self.hub
        out = self._device_step_out(frame, float(self.zebra.tm), cx, cy)
        step = self._device_step
        # mouse routing follows the step's static bands (the overlay slots'
        # source dims are the bands themselves)
        self._rects = {n: (r[0], r[1], r[2], r[3], step.dims[n][0] or r[2],
                           step.dims[n][1] or r[3])
                       for n, r in step.rects.items()}
        self._roi_shows_crop = False  # the dynamic preview is the full capture
        self._roi_crop_origin = (0, 0)
        wv_yuv = self.waveform.config.components.is_yuv
        hi_yuv = self.histogram.config.components.is_yuv
        wv_c = out.wv_counts if self.shown("waveform") else None
        hi_c = out.hi_counts.to(torch.int32) if self.shown("histogram") else None
        scap_w, scap_h = hub.capture_size
        surface = SurfaceData(
            result=AnalysisResult(
                yuv_planes=None,
                vs_counts=out.vs_counts if self.shown("vectorscope") else None,
                wv_rgb=None if wv_yuv else wv_c, wv_yuv=wv_c if wv_yuv else None,
                hi_rgb=None if hi_yuv else hi_c, hi_yuv=hi_c if hi_yuv else None,
                planes=out.planes,
            ),
            width=scap_w, height=scap_h, colorspace=hub.colorspace, cropped=False,
            dynamic_rect=tuple(rect),
        )
        for k in SCOPE_ORDER:
            self.scopes[k].surface_cb(surface)
        hub.last_surface = surface
        hub.frames_processed += 1
        return out.panel

    def render_device(self, frame, tm: float = 0.0, width: Optional[int] = None,
                      height: Optional[int] = None) -> np.ndarray:
        """The whole panel of one frame through ``make_dock_step`` (the
        dynamic-ROI step while the hub's rect is not the full frame),
        rebuilt when a config or the shape changes; the host panel."""
        cx = width or self.config.width
        cy = height or self.config.height
        return self._device_step_out(frame, tm, cx, cy).panel.cpu().numpy()

    def _device_confkey(self, full: bool) -> tuple:
        """Value identity of every config the dock step bakes in.  The ROI
        fields are left out when the rect is not full: the dynamic step
        takes the rect per frame, so a drag does not rebuild it."""
        fc = self.falsecolor.config
        return (
            config_key(self.hub.config, skip=() if full else ("x0", "y0", "x1", "y1")),
            config_key(self.config),
            config_key(self.vectorscope.config),
            config_key(self.waveform.config),
            config_key(self.histogram.config),
            config_key(self.zebra.config),
            config_key(fc, skip=("lut",)),
            None if fc.lut is None else FalseColor.lut_fingerprint(fc.lut),
            config_key(self.focuspeaking.config),
        )

    def _device_step_out(self, frame, tm: float, cx: int, cy: int):
        """Run the dock step (built for this shape and these configs) on a
        frame: a host or device (H, W, 4) u8 or packed frame, or a pending
        NV12 frame; returns its DockStepOutput."""
        nv12_cs, nv12_shift = None, 0
        if isinstance(frame, _NV12Pending):
            nv12_cs, nv12_shift = frame.cs, frame.shift
            arg = (frame.y, frame.uv)
        else:
            arg = self.hub.to_device(frame)
        h, w = self._frame_dims(frame)
        scale = self.hub.config.target_scale
        sw, sh = w // scale, h // scale
        self.hub.capture_size = (sw, sh)
        rect = self.hub.config.resolve_rect(sw, sh)
        full = rect == (0, 0, sw, sh)
        key = (h, w, cx, cy, full, nv12_cs, nv12_shift, self._device_confkey(full))
        if key != self._device_step_key:
            kwargs = dict(
                cs=self.hub.colorspace, scale=scale, out_width=cx, out_height=cy,
                dock=self.config, vectorscope=self.vectorscope.config,
                waveform=self.waveform.config, histogram=self.histogram.config,
                zebra=self.zebra.config, falsecolor=self.falsecolor.config,
                focuspeaking=self.focuspeaking.config, device=self.device,
            )
            if nv12_cs is not None:
                kwargs.update(input_format="nv12", nv12_cs=nv12_cs, nv12_shift=nv12_shift)
            self._device_step = make_dock_step(h, w, dynamic_roi=not full, **kwargs)
            self._device_step_key = key
        if full:
            return self._device_step(arg, tm)
        # the rect's four ints go into the captured step's rect buffer
        return self._device_step(arg, tm, tuple(rect))

    # -- mouse routing (reference src/scope-widget.cpp:241-428) --------------
    def _hit(self, x: int, y: int):
        """(name, scope-local x, scope-local y) of a panel position."""
        for name, (x0, y0, w, h, w_src, h_src) in self._rects.items():
            if x0 <= x < x0 + w and y0 <= y < y0 + h:
                return name, (x - x0) * w_src // max(w, 1), (y - y0) * h_src // max(h, 1)
        return None, 0, 0

    def mouse_wheel(self, x: int, y: int, delta_y: int) -> None:
        """The wheel over the vectorscope zooms it (reference
        vectorscope.c:473-482)."""
        if self._hit(x, y)[0] == "vectorscope":
            self.vectorscope.zoom_by(delta_y)

    def _set_roi_view(self) -> None:
        """Snapshot what the roi band is about to display: the crop or the
        full capture, and the crop's origin, the rect its planes were
        published under (never the live config, which a mid-drag commit may
        have moved past the displayed crop)."""
        rp = self.roi_preview
        self._roi_shows_crop = bool(rp._buf_cropped[rp._w_buf ^ 1])
        r = self._leaves_rect or self.hub.published_rect
        self._roi_crop_origin = (r[0], r[1]) if self._roi_shows_crop and r else (0, 0)

    def _roi_band_coords(self, x: int, y: int):
        """Panel coords -> scaled-capture coords through the roi band,
        unclamped (a drag may run outside the band; reference
        get_source_from_mouse, scope-widget.cpp:241-263)."""
        band = self._rects.get("roi")
        if band is None:
            return None
        x0b, y0b, wb, hb, ws, hs = band
        ox, oy = self._roi_crop_origin
        return (x - x0b) * ws // max(wb, 1) + ox, (y - y0b) * hs // max(hb, 1) + oy

    def _ensure_roi_interact(self) -> InteractiveROI:
        if self.roi_interact is None:
            # the interact space is the scaled capture (the reference's ROI
            # source always shows the full target, src/roi.c:279-315)
            w, h = self.hub.capture_size or (self.roi_preview.width or 1,
                                             self.roi_preview.height or 1)
            ri = self.roi_interact = InteractiveROI(width=w, height=h)
            c = self.hub.config
            ri.x0in, ri.y0in, ri.x1in, ri.y1in = c.x0, c.y0, c.x1, c.y1
        elif self.hub.capture_size:
            # the reference recomputes its dims per event (src/roi.c:146-156)
            self.roi_interact.width, self.roi_interact.height = self.hub.capture_size
        return self.roi_interact

    def _roi_dragging(self) -> bool:
        ri = self.roi_interact
        return ri is not None and bool(ri.flags & (DRAG_FIRST | DRAG_MOVE | DRAG_RESIZE))

    def mouse_move(self, x: int, y: int) -> None:
        name = self._hit(x, y)[0]
        if name == "roi" or self._roi_dragging():
            # a drag grabs the pointer (reference INTERACT_KEEP_SOURCE,
            # scope-widget.cpp:241-263,372-374)
            c = self._roi_band_coords(x, y)
            if c is None:
                return
            r = self._ensure_roi_interact()
            before = r.rect()
            r.mouse_move(*c)
            # a move-drag changes the committed rect continuously; the
            # reference pushes it every tick (roi_send_range, src/roi.c:478-520)
            if (r.flags & DRAG_MOVE) and r.rect() != before:
                r.apply_to(self.hub)
        elif self.roi_interact is not None and self.roi_interact.flags:
            # the hover left the band: the reference sends a LEAVE
            # (scope-widget.cpp:379-380), clearing the indicators
            self.roi_interact.mouse_move(0, 0, leave=True)

    def mouse_down(self, x: int, y: int) -> None:
        if self._hit(x, y)[0] == "roi":
            c = self._roi_band_coords(x, y)
            if c is not None:
                self._ensure_roi_interact().mouse_down(*c)

    def mouse_up(self, x: int, y: int) -> None:
        if self._hit(x, y)[0] == "roi" or self._roi_dragging():
            # a release outside the band still finishes the grabbed drag
            # (reference KEEP_SOURCE on release, scope-widget.cpp:329)
            c = self._roi_band_coords(x, y)
            if c is None:
                return
            r = self._ensure_roi_interact()
            r.mouse_up(*c)
            r.apply_to(self.hub)
