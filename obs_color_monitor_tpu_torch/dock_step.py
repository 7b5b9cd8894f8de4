"""The whole dock panel as one fixed sequence of launches per frame.

Counterpart of ``obs_color_monitor_tpu/dock_step.py`` (``make_dock_step``
``:222``, the static step ``:712-857``).  ``make_dock_step`` builds
(frame, tm) -> composited RGBA panel + statistics: NV12/P010 decode (K4,
K5), ``ops/fused.analyze`` (K1, K2), the three overlays on the capture
(K3), graticules, the false-colour key legend, zoom, and the panel.  The
panel lives in ``ops/compose``, which the streaming Dock shares: its
layout (the vertical stack with the reference's aspect rules,
src/scope-widget.cpp:99-175; :func:`_layout` is its boxes as this step
clamps them) and its assembly, one kernel launch on a card (KC) and its
plain version's torch ops on the CPU: the static step's panel from its
layout's slot table (the preview from the capture's planes, nearest
resizes, a 1:1 window; ``ops/compose.assemble_panel``).  With
``dynamic_roi=True`` (the JAX step_dyn, ``:485-710``) the ROI is a (4,)
int32 device tensor that K2, K3 and the panel's assembly read on the
device: a new rect changes no launch and no host work; the assembly (the
shaded preview, the slot samplers, the key legend and the composite) is
``ops/compose.compose_panel`` on the table that ``ops/compose.panel_table``
builds once.  On a CUDA device the step is captured once as a CUDA graph
and replayed (``graphs.CapturedStep``, the counterpart of the JAX step's
``@jax.jit``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .api import check_device
from .colorspace import Colorspace, calc_colorspace, quantize_unorm8
from .config import (
    DisplayMode,
    DockConfig,
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    ShowKey,
    VectorscopeColorType,
    VectorscopeConfig,
    WaveformConfig,
    ZebraConfig,
)
from .golden.reference import peaking_threshold_fixed
from .ops import compose
from .ops import render as render_ops
from .ops.compose import compose_vstack  # noqa: F401  (the JAX module's name)
from .ops.convert import (
    _as_device_arg,
    clamp_rect,
    nv12_to_packed,
    packed_view,
    planarize_packed,
    planes_to_rgba,
)
from .ops.fused import analyze
from .ops.fused_overlays import fused_overlays_planes
from .ops.graticule import (
    falsecolor_key_overlay,
    histogram_graticule,
    key_canvas_size,
    vectorscope_graticule,
    waveform_graticule,
)
from .ops.overlays import falsecolor_lut_planes

# Dock scope order (reference src/scope-widget.cpp:19-25), copied from
# ``obs_color_monitor_tpu/models/dock.py:40``.
SCOPE_ORDER = (
    "roi",
    "vectorscope",
    "waveform",
    "histogram",
    "zebra",
    "falsecolor",
    "focuspeaking",
)


class DockStepOutput(NamedTuple):
    """The JAX ``DockStepOutput`` fields, shapes and dtypes."""

    panel: torch.Tensor  # (out_h, out_w, 4) u8 composited dock
    # raw counts, channel selection deferred to read/render
    vs_counts: torch.Tensor  # (256, 256) u8 saturating
    wv_counts: torch.Tensor  # (3, 256, sw) u8 saturating, pre-select
    hi_counts: torch.Tensor  # (3, 256) u32, pre-select
    # the analyzed full-capture planes (4, sh, sw) u8 of a dynamic-ROI
    # build; None on static builds
    planes: Optional[torch.Tensor] = None

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Every field that is set, as a host numpy array, by field name."""
        return {k: v.detach().cpu().numpy() for k, v in self._asdict().items() if v is not None}


def _layout(shown_dims: list[tuple[str, int, int]], cx: int, cy: int, fp_actual: bool):
    """Static layout (reference draw, src/scope-widget.cpp:117-170;
    ``dock_step._layout``): :func:`ops.compose.panel_layout`'s fitted boxes,
    each at least one pixel wide and high."""
    return {n: (f.x0, f.y0, max(f.w, 1), max(f.h, 1))
            for n, (f, _) in compose.panel_layout(shown_dims, cx, cy, fp_actual).items()}



def make_dock_step(
    height: int,
    width: int,
    cs: Colorspace = Colorspace.BT709,
    scale: int = 2,
    out_width: int = 512,
    out_height: int = 1536,
    dock: Optional[DockConfig] = None,
    vectorscope: Optional[VectorscopeConfig] = None,
    waveform: Optional[WaveformConfig] = None,
    histogram: Optional[HistogramConfig] = None,
    zebra: Optional[ZebraConfig] = None,
    falsecolor: Optional[FalseColorConfig] = None,
    focuspeaking: Optional[FocusPeakingConfig] = None,
    overlays_on_capture: bool = True,
    roi_rect: Optional[tuple[int, int, int, int]] = None,
    dynamic_roi: bool = False,
    input_format: str = "rgba",
    nv12_cs: Optional[int] = None,
    nv12_shift: int = 0,
    *,
    device="cuda",
):
    """Build the dock step ``(frame, tm) -> DockStepOutput`` for a fixed
    frame shape, running on ``device``; with ``dynamic_roi`` the step is
    ``(frame, tm, rect)``.  A frame or plane is a tensor on ``device`` or a
    host array (numpy, JAX), which the step copies there; a tensor on
    another device raises.

    input_format "rgba" takes an (H, W, 4) u8 frame or its (H, W) int32 /
    uint32 packed view; "nv12" takes a ``(y (H, W), uv (H/2, W))`` pair of
    u8 planes, or of P010-family u16 planes with ``nv12_shift`` > 0
    (``ops.convert.nv12_shift``), decoded on the device in colorimetry
    ``nv12_cs`` (default ``cs``).  ``overlays_on_capture=True`` (the
    reference dock) runs the overlays on the scaled, cropped capture; False
    runs them on the full-resolution frame.  ``roi_rect`` is a static ROI
    (x0, y0, x1, y1) in scaled coordinates.  ``tm`` is the zebra stripe
    clock: a Python or numpy number, a 0-d host array, or a 0-d float32
    tensor on ``device`` (K3 reads it from device memory).

    ``dynamic_roi=True`` takes the ROI per frame as ``rect``, a (4,) int32
    tensor on ``device`` or a host rect (four Python or numpy ints, a (4,)
    integer array) in scaled coordinates, clamped as
    :func:`ops.convert.clamp_rect` says: the statistics and the overlay
    slots equal the static ``roi_rect`` build's at the same rect, the
    waveform counts stay full-width with the columns outside the rect zero,
    the ROI row shows the full capture with the selection shaded, and the
    output's ``planes`` hold the full scaled capture.  Nothing in the step
    reads the rect on the host, so every rect runs the same launches with
    the same shapes (a CUDA graph of one step replays for any rect).  It
    excludes ``roi_rect`` and needs ``overlays_on_capture=True``.

    On a CUDA device the returned step is captured as a CUDA graph on its
    first call and replayed after (``graphs.CapturedStep``): each call
    copies the frame, ``tm`` and the rect into the graph's buffers (a host
    rect as 4 ints written with ``fill_``) and returns fresh outputs.
    ``step.eager`` is the uncaptured step; ``step.rects`` and ``step.dims``
    are the static layout; a dynamic step's ``step.table`` is its panel's
    slot table (``ops/compose``).
    """
    from .graphs import captured

    if input_format not in ("rgba", "nv12"):
        raise ValueError(f"unknown input_format {input_format!r}")
    device = torch.device(device)
    dk = dock or DockConfig()
    vs_cfg = vectorscope or VectorscopeConfig()
    wv_cfg = waveform or WaveformConfig()
    hi_cfg = histogram or HistogramConfig()
    zb_cfg = zebra or ZebraConfig()
    fc_cfg = falsecolor or FalseColorConfig()
    fp_cfg = focuspeaking or FocusPeakingConfig()

    csi = int(calc_colorspace(cs))
    dec_cs = csi if nv12_cs is None else int(calc_colorspace(nv12_cs))
    # overlay scopes draw with their own colorspace property (reference
    # zbs_render uses src->cm.colorspace, src/zebra.c:620)
    zb_cs = int(calc_colorspace(zb_cfg.colorspace))
    fc_cs = int(calc_colorspace(fc_cfg.colorspace))
    sw, sh = width // scale, height // scale
    if roi_rect is not None:
        # ROI sub-rect in scaled coordinates (reference src/common.c:273-282)
        x0, y0, x1, y1 = roi_rect
        x0, y0 = max(0, x0), max(0, y0)
        x1 = sw if (x1 < 0 or x1 > sw) else x1
        y1 = sh if (y1 < 0 or y1 > sh) else y1
        roi_rect = (x0, y0, x1, y1)
        sw, sh = x1 - x0, y1 - y0
    wv_yuv = wv_cfg.components.is_yuv
    hi_yuv = hi_cfg.components.is_yuv
    wv_n = wv_cfg.components.n_components
    hi_n = hi_cfg.components.n_components
    sel = hi_cfg.components.channel_select()
    wv_sel = wv_cfg.components.channel_select()

    wv_w = sw * (wv_n if wv_cfg.display == DisplayMode.PARADE else 1)
    wv_h = 256 * (wv_n if wv_cfg.display == DisplayMode.STACK else 1)
    hi_w = 256 * (hi_n if hi_cfg.display == DisplayMode.PARADE else 1)
    hi_h = hi_cfg.level_height * (hi_n if hi_cfg.display == DisplayMode.STACK else 1)
    ov_w, ov_h = (sw, sh) if overlays_on_capture else (width, height)
    # the key legend extends the false-colour canvas for OUTSIDE/BELOW
    # (reference src/zebra.c:316-334)
    fc_w, fc_h = key_canvas_size(fc_cfg.show_key, ov_w, ov_h)
    dims = {
        "roi": (sw, sh),
        "vectorscope": (256, 256),
        "waveform": (wv_w, wv_h),
        "histogram": (hi_w, hi_h),
        "zebra": (ov_w, ov_h),
        "falsecolor": (fc_w, fc_h),
        "focuspeaking": (ov_w, ov_h),
    }
    if dynamic_roi:
        if roi_rect is not None:
            raise ValueError("dynamic_roi and roi_rect are mutually exclusive")
        if not overlays_on_capture:
            raise NotImplementedError(
                "dynamic_roi requires overlays_on_capture=True (the reference dock's "
                "configuration)")
        # the overlay slots become full static bands; the rect's aspect is
        # fitted inside them per frame
        dims = {**dims, "zebra": (0, 0), "falsecolor": (0, 0), "focuspeaking": (0, 0)}
    shown = [(n, *dims[n]) for n in SCOPE_ORDER if getattr(dk, f"show_{n}")]
    rects = _layout(shown, out_width, out_height, fp_cfg.actual_size)

    def on_device(a):
        return None if a is None else torch.as_tensor(np.ascontiguousarray(a), device=device)

    vs_grat = on_device(vectorscope_graticule(int(vs_cfg.graticule),
                                              vs_cfg.graticule_skintone_color, csi))
    wv_grat = on_device(waveform_graticule(wv_cfg.graticule_lines, sw, int(wv_cfg.display), wv_n))
    hi_grat = on_device(histogram_graticule(
        hi_cfg.graticule_vertical_lines, hi_cfg.graticule_horizontal_step,
        hi_cfg.level_height, int(hi_cfg.display), hi_n, hi_cfg.level_fixed,
        hi_cfg.level_ratio_permille, hi_cfg.logscale,
    ))
    peak_tuple = tuple(int(v) for v in quantize_unorm8(np.asarray(fp_cfg.peaking_rgba, np.float32)))
    peak_th = peaking_threshold_fixed(fp_cfg.peaking_threshold)
    fc_lut = on_device(fc_cfg.lut) if (fc_cfg.use_lut and fc_cfg.lut is not None) else None
    # key legend: a device constant, planar, blended per frame (reference
    # draws it per frame, src/zebra.c:385-597)
    fc_key = None
    if fc_cfg.show_key != ShowKey.NONE and not dynamic_roi:
        key_rgba = falsecolor_key_overlay(fc_cfg.show_key, ov_w, ov_h, fc_cs,
                                          lut=fc_cfg.lut if fc_cfg.use_lut else None)
        fc_key = on_device(np.moveaxis(key_rgba, -1, 0))
    # K3 computes whichever of the three overlays are shown, never the
    # user-LUT false colour (torch ops, as in JAX); without a key legend it
    # writes packed pixels, which the slot resizes read as they are
    k3_outputs = (dk.show_zebra, dk.show_falsecolor and fc_lut is None, dk.show_focuspeaking)
    packed_ov = fc_key is None
    k3_kw = dict(th_low=zb_cfg.th_low, th_high=zb_cfg.th_high, zb_cs=zb_cs, fc_cs=fc_cs,
                 peak_th=int(peak_th), peak_rgba=peak_tuple, packed_out=packed_ov,
                 outputs=k3_outputs)

    need_vs = dk.show_vectorscope
    need_wv = dk.show_waveform
    need_hi = dk.show_histogram
    frame_shape = (height, width)

    def _stat_renders(res, n_pixels, images):
        """Vectorscope/waveform/histogram renders and the step's raw count
        outputs (``dock_step.make_dock_step._stat_renders``): the drawn
        images apply the channel selection, the counts do not.  The shown
        scopes' images are one job table, drawn in one launch on a card
        (``render_ops.draw_stat_images``)."""
        jobs = {}
        if need_vs:
            jobs["vectorscope"] = render_ops.vectorscope_job(
                res.vs_counts, vs_grat, intensity=vs_cfg.intensity, cs=csi,
                white=vs_cfg.color_type == VectorscopeColorType.WHITE,
                zoom=round(vs_cfg.zoom, 3))
            vs_counts = res.vs_counts
        else:
            vs_counts = torch.zeros((256, 256), dtype=torch.uint8, device=device)
        if need_wv:
            wv_raw = res.wv_yuv if wv_yuv else res.wv_rgb
            jobs["waveform"] = render_ops.waveform_job(
                wv_raw, wv_grat, wv_sel, intensity=wv_cfg.intensity,
                display=int(wv_cfg.display), n_components=wv_n, yuv_mode=wv_yuv)
        else:
            wv_raw = torch.zeros((3, 256, sw), dtype=torch.uint8, device=device)
        if need_hi:
            hi_raw = res.hi_yuv if hi_yuv else res.hi_rgb
            jobs["histogram"] = render_ops.histogram_job(
                hi_raw, hi_grat, sel, n_pixels, level_fixed=hi_cfg.level_fixed,
                level_ratio_permille=hi_cfg.level_ratio_permille, logscale=hi_cfg.logscale,
                level_height=hi_cfg.level_height, display=int(hi_cfg.display),
                n_components=hi_n, yuv_mode=hi_yuv)
        else:
            hi_raw = torch.zeros((3, 256), dtype=torch.int32, device=device)
        images.update(zip(jobs, render_ops.draw_stat_images(jobs.values())))
        return vs_counts, wv_raw, hi_raw

    def source(frame) -> torch.Tensor:
        """The frame's packed view on the device, decoded from NV12/P010; a
        host frame or plane is copied to the device first."""
        if input_format == "nv12":
            y, uv = (_as_device_arg(p, device) for p in frame)
            check_device(y, device)
            if tuple(y.shape) != frame_shape:
                raise ValueError(f"nv12 y plane must be {frame_shape}, got {tuple(y.shape)}")
            return nv12_to_packed(y, uv, cs=dec_cs, shift=nv12_shift)
        frame = _as_device_arg(frame, device)
        check_device(frame, device)
        if tuple(frame.shape[:2]) != frame_shape:
            raise ValueError(f"frame must be {frame_shape} (+ 4 bytes), got "
                             f"{tuple(frame.shape)}")
        return packed_view(frame)

    if dynamic_roi:
        # the JAX step_dyn (``dock_step.py:485-710``): the panel is assembled
        # from the step's images by a slot table built here, once.  The key
        # legend is a texture at the band's resolution, sampled by the
        # display fraction of the dynamic fit and blended over it
        legend = None
        if "falsecolor" in rects and fc_cfg.show_key != ShowKey.NONE:
            ws_fc, hs_fc = rects["falsecolor"][2], rects["falsecolor"][3]
            base_w = ws_fc * 10 // 11 if fc_cfg.show_key == ShowKey.OUTSIDE else ws_fc
            base_h = hs_fc * 10 // 12 if fc_cfg.show_key == ShowKey.BELOW else hs_fc
            key = falsecolor_key_overlay(fc_cfg.show_key, base_w, base_h, fc_cs,
                                         lut=fc_cfg.lut if fc_cfg.use_lut else None)
            legend = torch.as_tensor(np.ascontiguousarray(key), device=device)
        table = compose.panel_table(
            [n for n, _, _ in shown], rects, dims, (sw, sh), (out_width, out_height),
            fp_actual=fp_cfg.actual_size,
            wv_parade=wv_n if wv_cfg.display == DisplayMode.PARADE and wv_n > 1 else 1,
            show_key=fc_cfg.show_key, legend=legend)

        def step_dyn(frame, tm: float, rect: torch.Tensor) -> DockStepOutput:
            src = source(frame)
            rect = _as_device_arg(rect, device)
            check_device(rect, device)
            if rect.dtype != torch.int32 or rect.shape != (4,):
                raise ValueError(f"rect must be a (4,) int32 array, got {tuple(rect.shape)} "
                                 f"{rect.dtype}")
            res = analyze(
                src, cs=csi, scale=scale, need_vs=need_vs,
                need_wv_rgb=need_wv and not wv_yuv, need_wv_yuv=need_wv and wv_yuv,
                need_hi_rgb=need_hi and not hi_yuv, need_hi_yuv=need_hi and hi_yuv,
                rect_dyn=rect,
            )
            rect_c = clamp_rect(rect, sw, sh)
            rx0, ry0, rx1, ry1 = rect_c.to(torch.int64)
            images = {"roi": res.planes}
            # the histogram's levels use the rect's pixel count
            vs_counts, wv_counts, hi_counts = _stat_renders(res, (rx1 - rx0) * (ry1 - ry0),
                                                            images)
            zb = fc = fp = None
            if any(k3_outputs):
                zb, fc, fp = fused_overlays_planes(res.planes, tm, rect=rect, **k3_kw)
            if dk.show_falsecolor and fc_lut is not None:
                fc = planes_to_rgba(falsecolor_lut_planes(res.planes, fc_lut, cs=fc_cs,
                                                          lut_n=fc_lut.shape[0]))
            images.update(zebra=zb, falsecolor=fc, focuspeaking=fp)
            return DockStepOutput(
                panel=compose.compose_panel(table, images, rect),
                vs_counts=vs_counts,
                wv_counts=wv_counts,
                hi_counts=hi_counts.to(torch.uint32),
                planes=res.planes,
            )

        return captured(step_dyn, device, rects=dict(rects), dims=dict(dims), table=table)

    # the static panel's boxes, at least one pixel each as in _layout
    boxes = {n: b._replace(w=max(b.w, 1), h=max(b.h, 1)) for n, (_, b) in
             compose.panel_layout(shown, out_width, out_height, fp_cfg.actual_size).items()}

    def step(frame, tm: float) -> DockStepOutput:
        src = source(frame)
        # with overlays on the capture the full-res frame feeds analyze
        # alone, as its packed view; otherwise the overlays need its planes
        planes = None if overlays_on_capture else planarize_packed(src)
        res = analyze(
            src if overlays_on_capture else planes,
            cs=csi, scale=scale, rect=roi_rect,
            need_vs=need_vs,
            need_wv_rgb=need_wv and not wv_yuv,
            need_wv_yuv=need_wv and wv_yuv,
            need_hi_rgb=need_hi and not hi_yuv,
            need_hi_yuv=need_hi and hi_yuv,
            is_planar=not overlays_on_capture,
        )
        images = {}
        if "roi" in rects:
            images["roi"] = compose.Preview(res.planes)
        vs_counts, wv_counts, hi_counts = _stat_renders(res, sw * sh, images)
        ov_src = res.planes if overlays_on_capture else planes
        zb = fc = fp = None
        if any(k3_outputs):
            zb, fc, fp = fused_overlays_planes(ov_src, tm, **k3_kw)
        to_image = lambda x: x if packed_ov else planes_to_rgba(x)
        if dk.show_zebra:
            images["zebra"] = to_image(zb)
        if dk.show_falsecolor:
            if fc_lut is not None:
                fc = falsecolor_lut_planes(ov_src, fc_lut, cs=fc_cs, lut_n=fc_lut.shape[0])
            if fc_key is not None:
                if (fc_h, fc_w) != (ov_h, ov_w):
                    canvas_fc = torch.zeros((4, fc_h, fc_w), dtype=torch.uint8, device=device)
                    canvas_fc[3] = 255
                    canvas_fc[:, :ov_h, :ov_w] = fc
                    fc = canvas_fc
                fc = render_ops.blend_overlay_planes(fc, fc_key)
            images["falsecolor"] = fc if fc.ndim == 2 else planes_to_rgba(fc)
        if dk.show_focuspeaking:
            images["focuspeaking"] = to_image(fp)
        return DockStepOutput(
            panel=compose.assemble_panel(images, boxes, out_width, out_height),
            vs_counts=vs_counts,
            wv_counts=wv_counts,
            hi_counts=hi_counts.to(torch.uint32),
        )

    return captured(step, device, rects=dict(rects), dims=dict(dims))
