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
  the JAX function's six outputs with its shapes;
* ``fused_ingest_stats_scale1/2``, the entry points of the TPU's kernel K9
  (``pallas_stats.py:419``), are K1's scale launch and K2 on a planar frame.

The input is the packed (H, W) int32 view of an RGBA frame or a planar
(4, H, W) u8 frame, or a batch of them, (B, H, W) or (B, 4, H, W): K1 takes
the batch in one launch (its grid's z axis, as ``vmap`` adds a grid axis to
the ``pallas_call``), each frame with its own zebra clock ``tm[b]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _kernels
from ..colorspace import FIXED_COEFFS, Colorspace
from ..golden.reference import luma_threshold_fixed
from . import overlays as ov
from .convert import as_packed, downscale_planes, luma_coef_fixed, planarize_packed
from .convert import rgb_to_yuv_planes
from .overlays import clock_tensor
from .scope_stats import vs_wv_counts, vs_wv_counts_reference

_I = ctypes.c_int


class PassParams(ctypes.Structure):
    """Mirror of ``PassParams`` in ``frame_pipeline.cu``."""

    _fields_ = [
        ("h4", _I), ("w4", _I), ("h", _I), ("w", _I), ("scale", _I),
        ("packed", _I), ("kyuv", _I * 12), ("vec", _I), ("fused", _I),
        ("tiles_x", _I), ("tiles_y", _I), ("scale_grid_x", _I), ("scale_grid_y", _I),
    ]


# K1's launch geometry, as frame_pipeline.cu lays it out: a tile-launch
# block owns TILE_H x TILE_W full-res pixels (its threads take runs of RUN
# pixels: TILE_W // RUN runs across, TILE_ROW_GROUPS rows at a time) and at
# scale 2 also the TILE_H // 2 x TILE_W // 2 scaled pixels under them; a
# scale-launch block makes SCALE_BLOCK_H rows of SCALE_BLOCK_W // RUN runs.
TILE_W, TILE_H, RUN = 256, 16, 4
TILE_ROW_GROUPS = 256 // (TILE_W // RUN)
SCALE_BLOCK_W, SCALE_BLOCK_H = 32 * RUN, 8


class FramePlan(NamedTuple):
    """How K1 runs on one frame shape: ``vec`` the 16-byte load form,
    ``fused`` the tile launch also writes the scale-2 planes, the tile
    launch's grid (0, 0 without overlays) and the scale launch's (0, 0
    when fused)."""

    vec: bool
    fused: bool
    tiles: tuple[int, int]
    scale_grid: tuple[int, int]


def frame_plan(h4: int, w4: int, scale: int, packed: bool, with_overlays: bool,
               base_aligned: bool = True) -> FramePlan:
    """K1's forms and grids for a (h4, w4) frame at ``scale``: pure, so the
    CPU tests hold it to cover every pixel once.  The wide-load form needs a
    16-byte aligned frame whose rows are too: W % 4 == 0 packed, W % 16 ==
    0 planar."""
    h, w = _scaled_dims(h4, w4, scale)
    vec = base_aligned and w4 % (4 if packed else 16) == 0
    fused = with_overlays and scale == 2
    tiles = (-(-w4 // TILE_W), -(-h4 // TILE_H)) if with_overlays else (0, 0)
    grid = (0, 0) if fused else (-(-w // SCALE_BLOCK_W), -(-h // SCALE_BLOCK_H))
    return FramePlan(vec, fused, tiles, grid)


class OverlayParams(ctypes.Structure):
    """Mirror of ``OverlayParams`` in ``overlay_math.cuh``."""

    _fields_ = [
        ("h", _I), ("w", _I), ("zb_lo", _I), ("zb_hi", _I),
        ("kl_zb", _I * 3), ("kl_fc", _I * 3),
        ("fc_thresh", _I * 11), ("fc_color", _I * 48),
        ("peak_th", _I), ("peak_rgba", _I * 4),
    ]


@functools.lru_cache(maxsize=64)
def _pass_params(h4, w4, scale, packed, cs, plan: FramePlan) -> PassParams:
    k = FIXED_COEFFS[Colorspace(cs)].reshape(-1).tolist()
    return PassParams(h4, w4, h4 // scale, w4 // scale, scale, int(packed), (_I * 12)(*k),
                      int(plan.vec), int(plan.fused), *plan.tiles, *plan.scale_grid)


@functools.lru_cache(maxsize=64)
def _overlay_params(h4, w4, th_low, th_high, zb_cs, fc_cs, peak_th, peak_rgba) -> OverlayParams:
    colors = ov.BAND_COLORS.reshape(-1).tolist()
    return OverlayParams(
        h4, w4, luma_threshold_fixed(th_low), luma_threshold_fixed(th_high),
        (_I * 3)(*luma_coef_fixed(zb_cs)), (_I * 3)(*luma_coef_fixed(fc_cs)),
        (_I * 11)(*ov.BAND_THRESH), (_I * 48)(*colors),
        int(peak_th), (_I * 4)(*peak_rgba),
    )


def batch_of(frame: torch.Tensor, packed: bool) -> int | None:
    """The batch size of a batched frame, (B, H, W) packed or (B, 4, H, W)
    planar; None for a single frame."""
    return frame.shape[0] if frame.ndim == (3 if packed else 4) else None


def _frame_dims(frame: torch.Tensor, packed: bool) -> tuple[int, int]:
    if packed:
        if frame.ndim not in (2, 3):
            raise ValueError(f"packed frame must be (H, W) or (B, H, W), got "
                             f"{tuple(frame.shape)}")
    elif frame.ndim not in (3, 4) or frame.shape[-3] != 4 or frame.dtype != torch.uint8:
        raise ValueError(f"planar frame must be (4, H, W) or (B, 4, H, W) u8, got "
                         f"{tuple(frame.shape)} {frame.dtype}")
    return frame.shape[-2], frame.shape[-1]


def _scaled_dims(h4: int, w4: int, scale: int) -> tuple[int, int]:
    if scale < 1:
        raise ValueError(f"scale must be >= 1, got {scale}")
    h, w = h4 // scale, w4 // scale
    if h == 0 or w == 0:
        raise ValueError(f"frame {w4}x{h4} too small for scale {scale}")
    return h, w


def check_frame_inputs(frame: torch.Tensor, packed: bool, scale: int,
                       tm: torch.Tensor | None = None) -> tuple[int, int, int, int]:
    """K1's argument checks (what the kernel takes): raise ValueError on
    anything else; return (H, W, h, w).  ``tm``: the clock tensor, 0-d for
    a single frame, (B,) for a batch of B, contiguous."""
    h4, w4 = _frame_dims(frame, packed)
    h, w = _scaled_dims(h4, w4, scale)
    if not frame.is_contiguous():
        raise ValueError("frame_pass: the frame must be contiguous")
    b = batch_of(frame, packed)
    if tm is not None and (tuple(tm.shape) != (() if b is None else (b,))
                           or not tm.is_contiguous()):
        raise ValueError(f"frame_pass: tm must be {'0-d' if b is None else (b,)} float32, got "
                         f"{tuple(tm.shape)}")
    return h4, w4, h, w


def frame_pass_reference(
    frame: torch.Tensor,
    tm: float | torch.Tensor = 0.0,
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
    overlays (4, H, W) u8 or None without overlays.  A batch runs frame by
    frame (frame b with ``tm[b]``) and each output gains a leading B."""
    h4, w4 = _frame_dims(frame, packed)
    _scaled_dims(h4, w4, scale)
    kw = dict(packed=packed, cs=cs, scale=scale, with_overlays=with_overlays, th_low=th_low,
              th_high=th_high, zb_cs=zb_cs, fc_cs=fc_cs, peak_th=peak_th, peak_rgba=peak_rgba)
    if batch_of(frame, packed) is not None:
        tm = clock_tensor(tm, frame.device)
        outs = [frame_pass_reference(f, tm[b] if tm.ndim else tm, **kw)
                for b, f in enumerate(frame)]
        return tuple(None if o[0] is None else torch.stack(o) for o in zip(*outs))
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
    tm: float | torch.Tensor = 0.0,
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
    :func:`frame_pass_reference` for the outputs), or over a batch of frames
    in one launch.  ``tm`` is the zebra clock: a Python float or a 0-d
    float32 tensor on the frame's device for one frame, a (B,) float32
    tensor for a batch; the kernel reads it from device memory.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
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
    dev = frame.device
    # only the tile launch (the overlays) reads the clock
    tm = clock_tensor(tm, dev) if with_overlays else None
    h4, w4, h, w = check_frame_inputs(frame, packed, scale, tm)
    b = batch_of(frame, packed)
    lead = () if b is None else (b,)
    ds = torch.empty((*lead, 4, h, w), dtype=torch.uint8, device=dev)
    yuv = torch.empty((*lead, 3, h, w), dtype=torch.uint8, device=dev)
    zb = fc = fp = None
    if with_overlays:
        zb, fc, fp = (torch.empty((*lead, 4, h4, w4), dtype=torch.uint8, device=dev)
                      for _ in range(3))
    plan = frame_plan(h4, w4, int(scale), bool(packed), bool(with_overlays),
                      frame.data_ptr() % 16 == 0)
    pp = _pass_params(h4, w4, int(scale), bool(packed), int(cs), plan)
    op = _overlay_params(h4, w4, float(th_low), float(th_high), int(zb_cs), int(fc_cs),
                         int(peak_th), kw["peak_rgba"])
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.ocm_frame_pass(
            ctypes.addressof(pp), ctypes.addressof(op), frame.data_ptr(), ptr(tm),
            1 if b is None else b, ptr(zb), ptr(fc), ptr(fp), ds.data_ptr(), yuv.data_ptr(),
            _kernels.stream_handle(dev),
        )
    frame_pass.launches += 1
    if plan.vec:
        frame_pass.launches_vec += 1
    _kernels.check(rc, "frame_pass")
    return ds, yuv, zb, fc, fp


# every call; of which in the 16-byte load form (frame_plan's ``vec``)
frame_pass.launches = 0
frame_pass.launches_vec = 0


def stats_inputs(ds: torch.Tensor, yuv: torch.Tensor, yuv_data: bool):
    """K2's inputs for a component family: (u, v, data, mask), of one frame
    or of a batch (a leading B on each).  The RGB family counts R, G, B and
    skips alpha-0 pixels; the YUV family counts Y, U, V and never skips
    (bit-exactness §4-5)."""
    u, v = yuv[..., 1, :, :], yuv[..., 2, :, :]
    if yuv_data:
        return u, v, yuv, None
    return u, v, ds[..., :3, :, :], ds[..., 3, :, :]


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


def _ingest(pass_fn, count_fn, planes, cs, scale, yuv_data):
    if planes.ndim != 3 or planes.shape[0] != 4 or planes.dtype != torch.uint8:
        raise ValueError(f"planes must be (4, H, W) u8, got {tuple(planes.shape)} {planes.dtype}")
    kw = dict(packed=False, cs=int(cs), scale=scale, with_overlays=False)
    vs, wv, ds, *_ = _pipeline(pass_fn, count_fn, planes, 0.0, yuv_data, kw)
    return vs, wv, ds


def fused_ingest_stats(planes: torch.Tensor, cs: int, scale: int, yuv_data: bool = False):
    """The fused ingest + statistics of a planar (4, H4, W4) u8 frame at
    ``scale`` 1 or 2: (vs (256, 256) int32, wv (3, 256, W) int32, ds
    (4, H, W) u8), unsaturated, with H = H4 // scale and W = W4 // scale
    (odd H4 or W4 crop to ``scale * H`` x ``scale * W``, as JAX's do).
    ``yuv_data`` picks the waveform's source: R, G, B skipping alpha-0
    pixels, or Y, U, V never skipping.

    Counterpart of ``pallas_stats._fused_ingest_stats`` (``:500``, kernel
    K9: ``_ingest_kernel`` ``:419`` launched at ``:532``, then
    ``_fused_kernel`` at ``:564``).  ``_ingest_kernel`` computes the scaled
    planes and their YUV per output pixel, which is what K1's scale launch
    writes, and ``_fused_kernel`` counts them, which is K2; so on a CUDA
    tensor this runs as K1 without overlays (one launch) and K2 (both
    counts), each booked by its own wrapper's launch count.  A CPU tensor
    runs the plain versions."""
    if scale not in (1, 2):
        raise ValueError(f"fused_ingest_stats: scale must be 1 or 2, got {scale}")
    return _ingest(frame_pass, vs_wv_counts, planes, cs, scale, yuv_data)


def fused_ingest_stats_reference(planes, cs: int, scale: int, yuv_data: bool = False):
    """Plain version of :func:`fused_ingest_stats` on any device."""
    return _ingest(frame_pass_reference, vs_wv_counts_reference, planes, cs, scale, yuv_data)


def fused_ingest_stats_scale1(planes: torch.Tensor, cs: int, yuv_data: bool = False):
    """(4, H, W) u8 planar -> (vs_i32 (256, 256), wv_i32 (3, 256, W)), the
    scale-1 statistics (``pallas_stats.fused_ingest_stats_scale1``
    ``:597``)."""
    vs, wv, _ = fused_ingest_stats(planes, cs, 1, yuv_data)
    return vs, wv


def fused_ingest_stats_scale2(planes: torch.Tensor, cs: int, yuv_data: bool = False):
    """Full-resolution (4, H4, W4) u8 planar -> (vs_i32 (256, 256), wv_i32
    (3, 256, W), ds (4, H, W)) with H = H4 // 2 and W = W4 // 2
    (``pallas_stats.fused_ingest_stats_scale2`` ``:614``)."""
    return fused_ingest_stats(planes, cs, 2, yuv_data)
