"""The whole dock panel as one fixed sequence of launches per frame.

Counterpart of ``obs_color_monitor_tpu/dock_step.py`` (``make_dock_step``
``:222``, the static step ``:712-857``).  ``make_dock_step`` builds
(frame, tm) -> composited RGBA panel + statistics: NV12/P010 decode (K4,
K5), ``ops/fused.analyze`` (K1, K2), the three overlays on the capture
(K3), graticules, the false-colour key legend, zoom, the vertical-stack
layout with the reference's aspect rules (src/scope-widget.cpp:99-175) and
the composite.  Layout is static, so the composite is slices and small
nearest-resize gathers.  With ``dynamic_roi=True`` (the JAX step_dyn,
``:485-710``) the ROI is a (4,) int32 device tensor that K2 and K3 read on
the device and the slot samplers gather by: a new rect changes no launch
and no host work.
"""

from __future__ import annotations

import functools
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
from .ops import render as render_ops
from .ops.convert import (
    OPAQUE_BLACK,
    clamp_rect,
    nv12_to_packed,
    packed_view,
    planarize_packed,
    planes_to_rgba,
    rgba_to_packed,
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
from .ops.stats import apply_channel_select, histogram_hi_max, histogram_levels

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


@functools.lru_cache(maxsize=256)
def _nearest_index(n_src: int, n_out: int, device: torch.device) -> torch.Tensor:
    """Source index of each of ``n_out`` nearest-resize samples."""
    idx = np.minimum((np.arange(n_out) * n_src) // n_out, n_src - 1)
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _rgba_view(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) u8 as it is, or the (H, W, 4) u8 bytes of an (H, W) int32
    packed image (no copy)."""
    if img.ndim == 2:
        return img.contiguous().view(torch.uint8).view(img.shape[0], img.shape[1], 4)
    return img


def _resize_nearest_rgba(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(H, W, 4) u8 or packed (H, W) int32 -> (oh, ow, 4) u8 nearest resize
    (``dock_step._resize_nearest_rgba``), as a plain index gather: the JAX
    one-hot column matmul exists only because lane gathers are slow on a
    TPU."""
    x = _rgba_view(img)
    h, w = x.shape[0], x.shape[1]
    return x.index_select(0, _nearest_index(h, oh, x.device)).index_select(
        1, _nearest_index(w, ow, x.device)
    )


def _packed_image(img: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 packed pixels of an (H, W, 4) u8 image (no copy when it
    is contiguous) or of a packed image as it is."""
    if img.ndim == 2:
        return img
    return rgba_to_packed(img)


def _floordiv(a, b):
    """Floor division of integer tensors, as JAX's ``//`` (the samplers
    divide negative numerators)."""
    return torch.div(a, b, rounding_mode="floor")


def _fit_dyn(slot_w: int, slot_h: int, src_w: torch.Tensor, src_h: torch.Tensor):
    """(fw, fh), 0-d int64 tensors: the largest box inside the static
    (slot_w, slot_h) band with the dynamic source aspect, by _layout's
    integer formula, so a rect equal to a static one gives the same panel
    (``dock_step._fit_dyn``)."""
    fw = torch.where(slot_w * src_h > slot_h * src_w,
                     _floordiv(slot_h * src_w, src_h.clamp(min=1)), slot_w)
    fh = torch.where(slot_h * src_w > slot_w * src_h,
                     _floordiv(slot_w * src_h, src_w.clamp(min=1)), slot_h)
    return fw.clamp(min=1), fh.clamp(min=1)


def _dyn_sample_rgba(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W, 4) u8 or packed (H, W) int32 -> (len(sy), len(sx), 4) u8, the
    pixels at rows ``sy`` and columns ``sx`` (int64 device tensors, clamped
    into the image): a gather of the packed view, rows then columns, exact
    by construction (``dock_step._dyn_sample_rgba``, whose one-hot matmul
    is the TPU's way around a lane gather).  ``valid`` (len(sy), len(sx))
    turns the pixels outside the fitted box opaque black."""
    x32 = _packed_image(img)
    h, w = x32.shape
    out = x32.index_select(0, sy.clamp(0, h - 1)).index_select(1, sx.clamp(0, w - 1))
    if valid is not None:
        out = torch.where(valid, out, OPAQUE_BLACK)
    return out.view(torch.uint8).view(out.shape[0], out.shape[1], 4)


def shaded_preview(planes: torch.Tensor, rect) -> torch.Tensor:
    """The ROI selection over the full capture: 50 % black outside the rect
    and a green border on its first and last rows and columns (reference
    draw_roi_range / draw_roi_rect, src/roi.c:207-265;
    ``models/dock._shaded_preview``).  ``rect`` (x0, y0, x1, y1) is a host
    sequence or a (4,) int32 tensor on the planes' device, used as given;
    (4, H, W) u8 in, (H, W, 4) u8 out."""
    r = torch.as_tensor(rect, dtype=torch.int32, device=planes.device)
    h, w = planes.shape[-2], planes.shape[-1]
    ri = torch.arange(h, dtype=torch.int32, device=planes.device)[:, None]
    ci = torch.arange(w, dtype=torch.int32, device=planes.device)[None, :]
    in_cols = (ci >= r[0]) & (ci < r[2])
    in_rows = (ri >= r[1]) & (ri < r[3])
    border = (((ri == r[1]) | (ri == r[3] - 1)) & in_cols) | (
        ((ci == r[0]) | (ci == r[2] - 1)) & in_rows)
    p = planes.to(torch.int32)
    shaded = torch.where(in_rows & in_cols, p[:3], (p[:3] * 128) // 255)
    chans = [shaded[0], shaded[1], shaded[2], p[3]]
    chans = [torch.where(border, g, c) for g, c in zip((0, 255, 0, 255), chans)]
    return planes_to_rgba(torch.stack(chans).to(torch.uint8))


def compose_vstack(patches: list, out_w: int, out_h: int) -> torch.Tensor:
    """Composite [(x0, y0, patch (h, w, 4) u8)] onto an opaque-black
    (out_h, out_w, 4) canvas (``dock_step.compose_vstack``).

    Patches that lie inside the canvas in y-sorted, non-overlapping order
    are padded to full-width row bands on their int32 pixel view and
    concatenated; anything else (a panel too short for its scope count,
    whose slots overlap) takes the update-slice loop, which clips like the
    reference draw and keeps its last-drawn-wins order."""
    dev = patches[0][2].device if patches else torch.device("cpu")
    stackable = all(
        b[1] >= a[1] + a[2].shape[0] for a, b in zip(patches, patches[1:])
    ) and all(
        0 <= y0 and y0 + p.shape[0] <= out_h and 0 <= x0 and x0 + p.shape[1] <= out_w
        for x0, y0, p in patches
    )
    if not stackable:
        canvas = torch.zeros((out_h, out_w, 4), dtype=torch.uint8, device=dev)
        canvas[..., 3] = 255
        for x0, y0, patch in patches:
            h, w = patch.shape[0], patch.shape[1]
            y0c, x0c = max(y0, 0), max(x0, 0)
            y1c, x1c = min(y0 + h, out_h), min(x0 + w, out_w)
            if y1c <= y0c or x1c <= x0c:
                continue
            canvas[y0c:y1c, x0c:x1c] = patch[y0c - y0 : y1c - y0, x0c - x0 : x1c - x0]
        return canvas
    black = lambda n: torch.full((n, out_w), OPAQUE_BLACK, dtype=torch.int32, device=dev)
    bands = []
    y = 0
    for x0, y0, patch in patches:
        h, w = patch.shape[0], patch.shape[1]
        if y0 > y:
            bands.append(black(y0 - y))
        p32 = rgba_to_packed(patch)
        bands.append(torch.nn.functional.pad(p32, (x0, out_w - x0 - w), value=OPAQUE_BLACK))
        y = y0 + h
    if y < out_h:
        bands.append(black(out_h - y))
    return torch.cat(bands, dim=0).view(torch.uint8).view(out_h, out_w, 4)


def _layout(shown_dims: list[tuple[str, int, int]], cx: int, cy: int, fp_actual: bool):
    """Static layout (reference draw, src/scope-widget.cpp:117-170;
    ``dock_step._layout``)."""
    rects = {}
    n_src = len(shown_dims)
    y0 = 0
    for k, (name, w_src, h_src) in enumerate(shown_dims):
        w, h = cx, (cy - y0) // (n_src - k)
        h_slot = h
        keep_aspect = name in ("roi", "zebra", "falsecolor") or (
            name == "focuspeaking" and not fp_actual
        )
        if name == "vectorscope":
            w = h = min(w, h)
        elif keep_aspect and w_src > 0 and h_src > 0:
            if w * h_src > h * w_src:
                w = h * w_src // h_src
            elif h * w_src > w * h_src:
                h = w * h_src // w_src
        rects[name] = ((cx - w) // 2, y0, max(w, 1), max(h, 1))
        y0 += h_slot
    return rects


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
    frame shape, running on ``device`` (its frames must be there already);
    with ``dynamic_roi`` the step is ``(frame, tm, rect)``.

    input_format "rgba" takes an (H, W, 4) u8 frame or its (H, W) int32 /
    uint32 packed view; "nv12" takes a ``(y (H, W), uv (H/2, W))`` pair of
    u8 planes, or of P010-family u16 planes with ``nv12_shift`` > 0
    (``ops.convert.nv12_shift``), decoded on the device in colorimetry
    ``nv12_cs`` (default ``cs``).  ``overlays_on_capture=True`` (the
    reference dock) runs the overlays on the scaled, cropped capture; False
    runs them on the full-resolution frame.  ``roi_rect`` is a static ROI
    (x0, y0, x1, y1) in scaled coordinates.  ``tm`` is the zebra stripe
    clock, a Python float.

    ``dynamic_roi=True`` takes the ROI per frame as ``rect``, a (4,) int32
    tensor on ``device`` in scaled coordinates, clamped as
    :func:`ops.convert.clamp_rect` says: the statistics and the overlay
    slots equal the static ``roi_rect`` build's at the same rect, the
    waveform counts stay full-width with the columns outside the rect zero,
    the ROI row shows the full capture with the selection shaded, and the
    output's ``planes`` hold the full scaled capture.  Nothing in the step
    reads the rect on the host, so every rect runs the same launches with
    the same shapes (a CUDA graph of one step replays for any rect).  It
    excludes ``roi_rect`` and needs ``overlays_on_capture=True``.
    """
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
        images apply the channel selection, the counts do not."""
        if need_vs:
            vs_img = render_ops.render_vectorscope(
                res.vs_counts, intensity=vs_cfg.intensity, cs=csi,
                white=vs_cfg.color_type == VectorscopeColorType.WHITE,
            )
            if vs_grat is not None:
                vs_img = render_ops.blend_overlay(vs_img, vs_grat)
            images["vectorscope"] = render_ops.zoom_center(vs_img, zoom=round(vs_cfg.zoom, 3))
            vs_counts = res.vs_counts
        else:
            vs_counts = torch.zeros((256, 256), dtype=torch.uint8, device=device)
        if need_wv:
            wv_raw = res.wv_yuv if wv_yuv else res.wv_rgb
            wv_img = render_ops.render_waveform(
                apply_channel_select(wv_raw, wv_sel), intensity=wv_cfg.intensity,
                display=int(wv_cfg.display), n_components=wv_n, yuv_mode=wv_yuv,
            )
            if wv_grat is not None:
                wv_img = render_ops.blend_overlay(wv_img, wv_grat)
            images["waveform"] = wv_img
        else:
            wv_raw = torch.zeros((3, 256, sw), dtype=torch.uint8, device=device)
        if need_hi:
            hi_raw = res.hi_yuv if hi_yuv else res.hi_rgb
            hi_counts = apply_channel_select(hi_raw, sel)
            hi = histogram_hi_max(hi_counts, sel, n_pixels, hi_cfg.level_fixed,
                                  hi_cfg.level_ratio_permille)
            levels, hi_eff = histogram_levels(hi_counts, hi, sel, hi_cfg.logscale)
            hi_img = render_ops.render_histogram(
                levels, hi_eff, level_height=hi_cfg.level_height,
                display=int(hi_cfg.display), n_components=hi_n, yuv_mode=hi_yuv,
            )
            if hi_grat is not None:
                hi_img = render_ops.blend_overlay(hi_img, hi_grat)
            images["histogram"] = hi_img
        else:
            hi_raw = torch.zeros((3, 256), dtype=torch.int32, device=device)
        return vs_counts, wv_raw, hi_raw

    def source(frame) -> torch.Tensor:
        """The frame's packed view on the device, decoded from NV12/P010."""
        if input_format == "nv12":
            y, uv = frame
            check_device(y, device)
            if tuple(y.shape) != frame_shape:
                raise ValueError(f"nv12 y plane must be {frame_shape}, got {tuple(y.shape)}")
            return nv12_to_packed(y, uv, cs=dec_cs, shift=nv12_shift)
        check_device(frame, device)
        if tuple(frame.shape[:2]) != frame_shape:
            raise ValueError(f"frame must be {frame_shape} (+ 4 bytes), got "
                             f"{tuple(frame.shape)}")
        return packed_view(frame)

    if dynamic_roi:
        # the JAX step_dyn (``dock_step.py:485-710``): every index the slot
        # samplers gather by is an integer tensor computed on the device from
        # the clamped rect; the static sizes are built here, once
        arange = lambda n: torch.arange(n, dtype=torch.int64, device=device)
        idx = {name: (arange(rects[name][2]), arange(rects[name][3])) for name, _, _ in shown}
        wv_sy = None
        if "waveform" in rects:
            hs, r_img = rects["waveform"][3], 256 * (
                wv_n if wv_cfg.display == DisplayMode.STACK else 1)
            wv_sy = torch.as_tensor(np.minimum(np.arange(hs) * r_img // hs, r_img - 1),
                                    dtype=torch.int64, device=device)
        # the key legend: a texture at the band's resolution, sampled by the
        # display fraction of the dynamic fit and blended over it (the canvas
        # maps affinely onto the fitted box; ``dock_step.py:387-405``)
        fc_key_dyn = None
        if "falsecolor" in rects and fc_cfg.show_key != ShowKey.NONE:
            ws_fc, hs_fc = rects["falsecolor"][2], rects["falsecolor"][3]
            base_w = ws_fc * 10 // 11 if fc_cfg.show_key == ShowKey.OUTSIDE else ws_fc
            base_h = hs_fc * 10 // 12 if fc_cfg.show_key == ShowKey.BELOW else hs_fc
            key = falsecolor_key_overlay(fc_cfg.show_key, base_w, base_h, fc_cs,
                                         lut=fc_cfg.lut if fc_cfg.use_lut else None)
            fc_key_dyn = torch.as_tensor(np.ascontiguousarray(key), device=device)
        parade = wv_cfg.display == DisplayMode.PARADE and wv_n > 1

        def key_patch(img, ws, hs, jj, ii, rx0, ry0, rw1, rh1):
            """The false-colour slot with its key legend: the canvas (the rect
            extended by the key strip) fitted into the band, the rect's pixels
            sampled through it and the legend texture blended over the box."""
            cw = _floordiv(rw1 * 11, 10) if fc_cfg.show_key == ShowKey.OUTSIDE else rw1
            ch = _floordiv(rh1 * 12, 10) if fc_cfg.show_key == ShowKey.BELOW else rh1
            fw, fh = _fit_dyn(ws, hs, cw, ch)
            dxo = _floordiv(ws - fw, 2)
            cx, cy = _floordiv((jj - dxo) * cw, fw), _floordiv(ii * ch, fh)
            col_in, row_in = (jj >= dxo) & (jj < dxo + fw), ii < fh
            valid = (row_in & (cy < rh1))[:, None] & (col_in & (cx < rw1))[None, :]
            base = _dyn_sample_rgba(img, ry0 + torch.minimum(cy.clamp(min=0), rh1 - 1),
                                    rx0 + torch.minimum(cx.clamp(min=0), rw1 - 1), valid)
            lh, lw = fc_key_dyn.shape[0], fc_key_dyn.shape[1]
            lg = _dyn_sample_rgba(fc_key_dyn, _floordiv(ii * lh, fh).clamp(0, lh - 1),
                                  _floordiv((jj - dxo) * lw, fw).clamp(0, lw - 1))
            a = torch.where(row_in[:, None] & col_in[None, :], lg[..., 3].to(torch.int32), 0)
            a = a[..., None]
            rgb = (lg[..., :3].to(torch.int32) * a + base[..., :3].to(torch.int32) * (255 - a)
                   + 127) // 255
            return torch.cat([rgb.to(torch.uint8), base[..., 3:]], dim=-1)

        def step_dyn(frame, tm: float, rect: torch.Tensor) -> DockStepOutput:
            src = source(frame)
            check_device(rect, device)
            if rect.dtype != torch.int32 or rect.shape != (4,):
                raise ValueError(f"rect must be a (4,) int32 tensor, got {tuple(rect.shape)} "
                                 f"{rect.dtype}")
            res = analyze(
                src, cs=csi, scale=scale, need_vs=need_vs,
                need_wv_rgb=need_wv and not wv_yuv, need_wv_yuv=need_wv and wv_yuv,
                need_hi_rgb=need_hi and not hi_yuv, need_hi_yuv=need_hi and hi_yuv,
                rect_dyn=rect,
            )
            rect_c = clamp_rect(rect, sw, sh)
            rx0, ry0, rx1, ry1 = rect_c.to(torch.int64)
            rw, rh = rx1 - rx0, ry1 - ry0
            rw1, rh1 = rw.clamp(min=1), rh.clamp(min=1)
            images = {}
            if "roi" in rects:
                images["roi"] = shaded_preview(res.planes, rect_c)
            # the histogram's levels use the rect's pixel count
            vs_counts, wv_counts, hi_counts = _stat_renders(res, rw * rh, images)
            zb = fc = fp = None
            if any(k3_outputs):
                zb, fc, fp = fused_overlays_planes(res.planes, tm, rect=rect, **k3_kw)
            if dk.show_falsecolor and fc_lut is not None:
                fc = planes_to_rgba(falsecolor_lut_planes(res.planes, fc_lut, cs=fc_cs,
                                                          lut_n=fc_lut.shape[0]))
            images.update(zebra=zb, falsecolor=fc, focuspeaking=fp)

            patches = []
            for name, _, _ in shown:
                x0s, y0s, ws, hs = rects[name]
                img = images[name]
                if name in ("roi", "vectorscope", "histogram"):
                    patches.append((x0s, y0s, _resize_nearest_rgba(img, hs, ws)))
                    continue
                jj, ii = idx[name]
                if name == "waveform":
                    # the rect's columns stretched across the slot; in parade
                    # mode through the per-component segments first
                    if parade:
                        m = _floordiv(jj * (rw1 * wv_n), ws)
                        cseg = _floordiv(m, rw1)
                        src_j = cseg * sw + rx0 + (m - cseg * rw1)
                    else:
                        src_j = rx0 + _floordiv(jj * rw1, ws)
                    patches.append((x0s, y0s, _dyn_sample_rgba(img, wv_sy, src_j)))
                    continue
                if name == "falsecolor" and fc_key_dyn is not None:
                    patch = key_patch(img, ws, hs, jj, ii, rx0, ry0, rw1, rh1)
                    patches.append((x0s, y0s, patch))
                    continue
                # content x-centred and top-aligned in its band, as _layout
                # places the static patch
                if name == "focuspeaking" and fp_cfg.actual_size:
                    # 1:1 pixels, centred on the rect, cropped to the slot
                    fw, fh = rw1.clamp(max=ws), rh1.clamp(max=hs)
                    dxo = _floordiv(ws - fw, 2)
                    src_j = rx0 + _floordiv(rw1 - fw, 2) + (jj - dxo)
                    sy = ry0 + _floordiv(rh1 - fh, 2) + ii
                else:
                    fw, fh = _fit_dyn(ws, hs, rw1, rh1)
                    dxo = _floordiv(ws - fw, 2)
                    src_j = rx0 + _floordiv((jj - dxo) * rw1, fw)
                    sy = ry0 + _floordiv(ii * rh1, fh)
                valid = (ii < fh)[:, None] & ((jj >= dxo) & (jj < dxo + fw))[None, :]
                patches.append((x0s, y0s, _dyn_sample_rgba(img, sy, src_j, valid)))
            return DockStepOutput(
                panel=compose_vstack(patches, out_width, out_height),
                vs_counts=vs_counts,
                wv_counts=wv_counts,
                hi_counts=hi_counts.to(torch.uint32),
                planes=res.planes,
            )

        step_dyn.rects = dict(rects)
        step_dyn.dims = dict(dims)
        return step_dyn

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
            images["roi"] = planes_to_rgba(res.planes)
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

        patches = []
        for name, w_src, h_src in shown:
            x0, y0, w, h = rects[name]
            if name == "focuspeaking" and fp_cfg.actual_size:
                # 1:1 pixel mapping, centred, cropped to the slot (reference
                # set_actual_size_matrix, focuspeaking.c:203-220)
                w, h = min(w, w_src), min(h, h_src)
                cx0, cy0 = (w_src - w) // 2, (h_src - h) // 2
                patch = _rgba_view(images[name])[cy0 : cy0 + h, cx0 : cx0 + w]
                x0 = (out_width - w) // 2
            else:
                patch = _resize_nearest_rgba(images[name], h, w)
            patches.append((x0, y0, patch))
        return DockStepOutput(
            panel=compose_vstack(patches, out_width, out_height),
            vs_counts=vs_counts,
            wv_counts=wv_counts,
            hi_counts=hi_counts.to(torch.uint32),
        )

    step.rects = dict(rects)
    step.dims = dict(dims)
    return step
