"""The whole-frame pass: the wrapper of kernel K1, its plain version, and
``frame_pipeline`` (K1 then K2).

Counterpart of ``obs_color_monitor_tpu/ops/pallas_pipeline.py``
(``frame_pipeline`` ``:290``, kernel ``_pipeline_kernel`` ``:149``).  The
TPU kernel sweeps 64-row bands, writes stats tiles for its second kernel
and corrects padding and alpha counts afterwards; its contract is kept
here, not its layout:

* ``frame_pass`` (K1, ``ops/csrc/frame_pipeline.cu``) reads the full-res
  frame and writes the three overlays (full-res planar), the scaled planes
  at any integer scale, and the Q12 YUV planes of the scaled frame;
* ``frame_pipeline`` feeds those to K2 (``ops/scope_stats.py``) and returns
  the JAX function's six outputs with its shapes.

The input is the packed (H, W) int32 view of an RGBA frame or a planar
(4, H, W) u8 frame.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from ..colorspace import FIXED_COEFFS, Colorspace
from ..golden.reference import luma_threshold_fixed
from . import overlays as ov
from .convert import as_packed, downscale_planes, luma_coef_fixed, planarize_packed
from .convert import rgb_to_yuv_planes
from .scope_stats import vs_wv_counts, vs_wv_counts_reference

_I = ctypes.c_int


class PassParams(ctypes.Structure):
    """Mirror of ``PassParams`` in ``frame_pipeline.cu``."""

    _fields_ = [
        ("h4", _I), ("w4", _I), ("h", _I), ("w", _I), ("scale", _I),
        ("packed", _I), ("kyuv", _I * 12),
    ]


class OverlayParams(ctypes.Structure):
    """Mirror of ``OverlayParams`` in ``overlay_math.cuh``."""

    _fields_ = [
        ("h", _I), ("w", _I), ("zb_lo", _I), ("zb_hi", _I),
        ("kl_zb", _I * 3), ("kl_fc", _I * 3),
        ("fc_thresh", _I * 11), ("fc_color", _I * 48),
        ("peak_th", _I), ("peak_rgba", _I * 4),
    ]


@functools.lru_cache(maxsize=64)
def _pass_params(h4, w4, scale, packed, cs) -> PassParams:
    k = FIXED_COEFFS[Colorspace(cs)].reshape(-1).tolist()
    return PassParams(h4, w4, h4 // scale, w4 // scale, scale, int(packed), (_I * 12)(*k))


@functools.lru_cache(maxsize=64)
def _overlay_params(h4, w4, th_low, th_high, zb_cs, fc_cs, peak_th, peak_rgba) -> OverlayParams:
    colors = ov.BAND_COLORS.reshape(-1).tolist()
    return OverlayParams(
        h4, w4, luma_threshold_fixed(th_low), luma_threshold_fixed(th_high),
        (_I * 3)(*luma_coef_fixed(zb_cs)), (_I * 3)(*luma_coef_fixed(fc_cs)),
        (_I * 11)(*ov.BAND_THRESH), (_I * 48)(*colors),
        int(peak_th), (_I * 4)(*peak_rgba),
    )


def _frame_dims(frame: torch.Tensor, packed: bool) -> tuple[int, int]:
    if packed:
        if frame.ndim != 2:
            raise ValueError(f"packed frame must be (H, W), got {tuple(frame.shape)}")
    elif frame.ndim != 3 or frame.shape[0] != 4 or frame.dtype != torch.uint8:
        raise ValueError(f"planar frame must be (4, H, W) u8, got {tuple(frame.shape)} {frame.dtype}")
    return frame.shape[-2], frame.shape[-1]


def _scaled_dims(h4: int, w4: int, scale: int) -> tuple[int, int]:
    if scale < 1:
        raise ValueError(f"scale must be >= 1, got {scale}")
    h, w = h4 // scale, w4 // scale
    if h == 0 or w == 0:
        raise ValueError(f"frame {w4}x{h4} too small for scale {scale}")
    return h, w


def frame_pass_reference(
    frame: torch.Tensor,
    tm: float = 0.0,
    *,
    packed: bool,
    cs: int,
    scale: int,
    with_overlays: bool = True,
    th_low: float = 0.75,
    th_high: float = 1.0,
    zb_cs: int = 2,
    fc_cs: int = 2,
    peak_th: int = 3062,
    peak_rgba: tuple[int, int, int, int] = (255, 0, 0, 255),
):
    """Plain version of K1, composed from the convert and overlay ops:
    (ds (4, h, w), yuv (3, h, w), zebra, falsecolor, focuspeaking), the
    overlays (4, H, W) u8 or None without overlays."""
    h4, w4 = _frame_dims(frame, packed)
    _scaled_dims(h4, w4, scale)
    planes = planarize_packed(frame) if packed else frame
    ds = downscale_planes(planes, scale).contiguous()
    yuv = rgb_to_yuv_planes(ds, cs)
    zb = fc = fp = None
    if with_overlays:
        zb = ov.zebra_planes(planes, th_low, th_high, tm, zb_cs)
        fc = ov.falsecolor_planes(planes, fc_cs)
        fp = ov.focus_peaking_planes(planes, peak_th, peak_rgba)
    return ds, yuv, zb, fc, fp


def frame_pass(
    frame: torch.Tensor,
    tm: float = 0.0,
    *,
    packed: bool,
    cs: int,
    scale: int,
    with_overlays: bool = True,
    th_low: float = 0.75,
    th_high: float = 1.0,
    zb_cs: int = 2,
    fc_cs: int = 2,
    peak_th: int = 3062,
    peak_rgba: tuple[int, int, int, int] = (255, 0, 0, 255),
):
    """K1: one pass over the full-res frame (see
    :func:`frame_pass_reference` for the outputs).  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel."""
    kw = dict(
        packed=packed, cs=cs, scale=scale, with_overlays=with_overlays,
        th_low=th_low, th_high=th_high, zb_cs=zb_cs, fc_cs=fc_cs,
        peak_th=peak_th, peak_rgba=tuple(int(c) for c in peak_rgba),
    )
    if packed:
        frame = as_packed(frame)
    if frame.device.type == "cpu":
        return frame_pass_reference(frame, tm, **kw)
    if frame.device.type != "cuda":
        raise ValueError(f"frame_pass: unsupported device {frame.device}")
    h4, w4 = _frame_dims(frame, packed)
    h, w = _scaled_dims(h4, w4, scale)
    if not frame.is_contiguous():
        raise ValueError("frame_pass: the frame must be contiguous")
    dev = frame.device
    ds = torch.empty((4, h, w), dtype=torch.uint8, device=dev)
    yuv = torch.empty((3, h, w), dtype=torch.uint8, device=dev)
    zb = fc = fp = None
    if with_overlays:
        zb, fc, fp = (torch.empty((4, h4, w4), dtype=torch.uint8, device=dev) for _ in range(3))
    pp = _pass_params(h4, w4, int(scale), bool(packed), int(cs))
    op = _overlay_params(h4, w4, float(th_low), float(th_high), int(zb_cs), int(fc_cs),
                         int(peak_th), kw["peak_rgba"])
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.ocm_frame_pass(
            ctypes.addressof(pp), ctypes.addressof(op), frame.data_ptr(), float(tm),
            ptr(zb), ptr(fc), ptr(fp), ds.data_ptr(), yuv.data_ptr(),
            _kernels.stream_handle(dev),
        )
    frame_pass.launches += 1
    _kernels.check(rc, "frame_pass")
    return ds, yuv, zb, fc, fp


frame_pass.launches = 0


def stats_inputs(ds: torch.Tensor, yuv: torch.Tensor, yuv_data: bool):
    """K2's inputs for a component family: (u, v, data, mask).  The RGB
    family counts R, G, B and skips alpha-0 pixels; the YUV family counts
    Y, U, V and never skips (bit-exactness §4-5)."""
    if yuv_data:
        return yuv[1], yuv[2], yuv, None
    return yuv[1], yuv[2], ds[:3], ds[3]


def _pipeline(pass_fn, count_fn, frame, tm, yuv_data, kw):
    ds, yuv, zb, fc, fp = pass_fn(frame, tm, **kw)
    vs, wv = count_fn(*stats_inputs(ds, yuv, yuv_data))
    return vs, wv, ds, zb, fc, fp


def frame_pipeline(frame, tm=0.0, *, yuv_data: bool = False, **kw):
    """(vs_i32 (256, 256), wv_i32 (3, 256, w), ds (4, h, w), zebra,
    falsecolor, focuspeaking) as the JAX ``frame_pipeline`` returns them,
    at any integer scale.  Keywords as :func:`frame_pass`
    (``packed`` defaults to False here, as in JAX)."""
    kw.setdefault("packed", False)
    return _pipeline(frame_pass, vs_wv_counts, frame, tm, yuv_data, kw)


def frame_pipeline_reference(frame, tm=0.0, *, yuv_data: bool = False, **kw):
    """Plain version of :func:`frame_pipeline` on any device."""
    kw.setdefault("packed", False)
    return _pipeline(frame_pass_reference, vs_wv_counts_reference, frame, tm, yuv_data, kw)
