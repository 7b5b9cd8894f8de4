"""Zebra, false colour and focus peaking in one pass: the wrapper of kernel
K3 and its plain version.

Counterpart of ``obs_color_monitor_tpu/ops/pallas_overlays.py``
(``fused_overlays_planes`` ``:208``, kernel ``_ov_kernel`` ``:173``).  The
plain version composes the three overlay ops of ``ops/overlays.py``; the
CUDA source is ``ops/csrc/fused_overlays.cu``, which shares its tile
machinery (``ops/csrc/tile_pass.cuh``) with K1's tile pass and computes
the overlay rules of ``ops/csrc/overlay_math.cuh`` on whole words.
:func:`overlay_plan` picks its grid and forms; :func:`fc_bucket_table` is
its false-colour band table.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from . import overlays as ov
from .convert import clamp_rect, interleave, luma_coef_fixed, rgba_to_packed
from .overlays import clock_tensor
from .pipeline import _overlay_params

ALL = (True, True, True)
_I = ctypes.c_int


class OverlayLaunch(ctypes.Structure):
    """Mirror of ``OverlayLaunch`` in ``fused_overlays.cu``."""

    _fields_ = [("vec", _I), ("packed_out", _I), ("word", _I), ("tiles_x", _I), ("tiles_y", _I)]


# K3's launch geometry, as fused_overlays.cu lays it out: a block of
# THREADS threads owns a TILE_H x TILE_W tile, its threads take runs of RUN
# pixels (TILE_W // RUN runs across, one warp per tile row; ROW_GROUPS rows
# at a time).  32 x 128 tiles cut the dock's 1920x1080 capture into 15 x 34
# = 510 blocks: one wave of the 528 that the H100's 132 SMs hold at 4
# blocks each (its registers allow 4 of 256 threads), where 16 x 256 tiles
# (544 blocks) would leave a 16-block second wave.  At 4K full resolution
# 2040 blocks fill 3.9 waves.
TILE_W, TILE_H, RUN, THREADS = 128, 32, 4, 256
ROW_GROUPS = THREADS // (TILE_W // RUN)


class OverlayPlan(NamedTuple):
    """How K3 runs on one frame shape: ``vec`` the 16-byte cp.async tile
    copies, ``store_bytes`` the width of each output store (16: a run of 4
    packed pixels; 4: a packed pixel, or a run's word of one plane; 1: a
    byte), ``tiles`` the grid (0, 0 for an empty frame)."""

    vec: bool
    store_bytes: int
    tiles: tuple[int, int]


def overlay_plan(h: int, w: int, packed_out: bool, aligned: bool = True) -> OverlayPlan:
    """K3's forms and grid for (4, h, w) planes: pure, so the CPU tests hold
    it to cover every pixel once.  The 16-byte copies need a 16-byte
    aligned base (``aligned``) and rows (w % 16 == 0); the runs' word
    stores need w % 4 == 0 (the outputs are the wrapper's own allocations,
    always aligned)."""
    if h < 0 or w < 0:
        raise ValueError(f"overlay_plan: bad shape {h}x{w}")
    word = w % 4 == 0
    store_bytes = (16 if word else 4) if packed_out else (4 if word else 1)
    tiles = (-(-w // TILE_W), -(-h // TILE_H)) if h and w else (0, 0)
    if tiles[1] > 65535:
        raise ValueError(f"overlay_plan: {h} rows exceed the grid")
    return OverlayPlan(aligned and w % 16 == 0, store_bytes, tiles)


# K3 reads the false-colour band by luma >> 12 from a table of FC_BUCKETS
# words (the kernel's shared copy)
FC_BUCKETS = 256
FC_NONE = 0xFFFFF  # a bucket without a band bound: above every luma


def fc_bucket_table(thresh=ov.BAND_THRESH) -> np.ndarray:
    """The false-colour band table K3 reads: for each bucket b of luma >>
    12, ``(bounds below b << 12) << 20 | the bound inside the bucket`` (or
    FC_NONE), so that band(luma) = entry >> 20 + (luma >= entry & 0xFFFFF)
    counts the bounds <= luma.  Raises ValueError unless the bounds ascend,
    stay under FC_NONE and no bucket holds two of them."""
    t = np.asarray(thresh, np.int64)
    if np.any(np.diff(t) <= 0) or t.min() < 0 or t.max() >= FC_NONE:
        raise ValueError(f"fc_bucket_table: bounds must ascend in [0, {FC_NONE}), got {thresh}")
    bucket = t >> 12
    if len(np.unique(bucket)) != len(t):
        raise ValueError(f"fc_bucket_table: two band bounds share a bucket of 4096: {thresh}")
    edges = np.arange(FC_BUCKETS, dtype=np.int64) << 12
    below = (t[None, :] < edges[:, None]).sum(axis=1)
    inside = np.full(FC_BUCKETS, FC_NONE, np.int64)
    inside[bucket] = t
    return ((below << 20) | inside).astype(np.uint32)


def check_luma_coefficients(cs: int) -> tuple[int, int, int]:
    """The Q12 luma coefficients of ``cs`` as K3 takes them: each a 16-bit
    value (split into two bytes for dp4a), and every luma of u8 RGB under
    FC_NONE, so in the band table's range."""
    k = luma_coef_fixed(cs)
    if min(k) < 0 or max(k) >= 1 << 16 or 255 * sum(k) >= FC_NONE:
        raise ValueError(f"colorspace {cs}: luma coefficients {k} out of K3's range")
    return k


@functools.lru_cache(maxsize=8)
def _fc_buckets(device) -> torch.Tensor:
    """The band table on ``device``, made once (before any CUDA graph
    capture of a step, whose warm-up calls make it)."""
    return torch.from_numpy(fc_bucket_table().view(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _launch_args(h, w, th_low, th_high, zb_cs, fc_cs, peak_th, peak_rgba, packed_out, aligned):
    """K3's kernel arguments by their static values: (OverlayParams,
    OverlayLaunch, their addresses, the plan), built once per set."""
    check_luma_coefficients(zb_cs)
    check_luma_coefficients(fc_cs)
    op = _overlay_params(h, w, float(th_low), float(th_high), int(zb_cs), int(fc_cs),
                         int(peak_th), tuple(int(c) for c in peak_rgba))
    plan = overlay_plan(h, w, packed_out, aligned)
    lp = OverlayLaunch(int(plan.vec), int(packed_out), int(w % 4 == 0), *plan.tiles)
    return op, lp, ctypes.addressof(op), ctypes.addressof(lp), plan


def packed_from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(4, H, W) u8 -> the (H, W) int32 packed view of its RGBA bytes
    (byte 0 = R), as the kernel's ``packed_out`` composes it."""
    return rgba_to_packed(interleave(planes))


def _tm_rect(tm, rect_c: torch.Tensor | None, device) -> torch.Tensor:
    """The zebra clock (a float, or a 0-d float32 tensor taken as it is)
    with its phase anchored at the clamped rect's origin: ``tm - (x0 +
    y0)``, one float32 subtraction, as the JAX kernel and dynamic dock
    compute it (``pallas_overlays.py:81``)."""
    tm32 = clock_tensor(tm, device)
    return tm32 if rect_c is None else tm32 - (rect_c[0] + rect_c[1]).to(torch.float32)


def fused_overlays_reference(
    planes: torch.Tensor,
    tm: float | torch.Tensor,
    *,
    th_low: float,
    th_high: float,
    zb_cs: int,
    fc_cs: int,
    peak_th: int,
    peak_rgba: tuple[int, int, int, int],
    rect=None,
    packed_out: bool = False,
    outputs: tuple[bool, bool, bool] = ALL,
):
    """Plain version of K3: (zebra, falsecolor, focuspeaking), each (4, H, W)
    u8, or (H, W) int32 packed RGBA with ``packed_out``; an output whose
    ``outputs`` flag is off is None."""
    h, w = planes.shape[-2], planes.shape[-1]
    rect_c = None if rect is None else clamp_rect(rect, w, h, planes.device)
    zb = fc = fp = None
    if outputs[0]:
        zb = ov.zebra_planes(planes, th_low, th_high, _tm_rect(tm, rect_c, planes.device), zb_cs)
    if outputs[1]:
        fc = ov.falsecolor_planes(planes, fc_cs)
    if outputs[2]:
        fp = ov.focus_peaking_planes(planes, peak_th, peak_rgba, rect=rect_c)
    if packed_out:
        return tuple(None if x is None else packed_from_planes(x) for x in (zb, fc, fp))
    return zb, fc, fp


def check_overlay_inputs(planes: torch.Tensor, rect, outputs, tm=None) -> tuple[int, int]:
    """K3's argument checks (what the kernel takes): raise ValueError on
    anything else; return (H, W).  ``tm``: the 0-d clock tensor."""
    if tm is not None and tm.shape != ():
        raise ValueError(f"tm must be a 0-d float32 tensor, got {tuple(tm.shape)}")
    if planes.ndim != 3 or planes.shape[0] != 4 or planes.dtype != torch.uint8:
        raise ValueError(f"planes must be (4, H, W) u8, got {tuple(planes.shape)} {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("fused_overlays_planes: the planes must be contiguous")
    if not any(outputs):
        raise ValueError("fused_overlays_planes: no output enabled")
    if isinstance(rect, torch.Tensor):
        if rect.dtype != torch.int32 or rect.shape != (4,) or not rect.is_contiguous():
            raise ValueError(f"rect must be a contiguous (4,) int32 tensor, got "
                             f"{tuple(rect.shape)} {rect.dtype}")
        if rect.device != planes.device:
            raise ValueError(f"rect on {rect.device}, the planes on {planes.device}")
    return planes.shape[1], planes.shape[2]


def fused_overlays_planes(
    planes: torch.Tensor,
    tm: float | torch.Tensor,
    *,
    th_low: float,
    th_high: float,
    zb_cs: int,
    fc_cs: int,
    peak_th: int,
    peak_rgba: tuple[int, int, int, int],
    rect=None,
    packed_out: bool = False,
    outputs: tuple[bool, bool, bool] = ALL,
):
    """K3: the three overlays of a planar (4, H, W) u8 frame in one pass,
    each with its own colorspace (``zb_cs``, ``fc_cs``).

    ``rect`` (x0, y0, x1, y1): pixels inside it equal the overlays of the
    cropped frame (zebra phase anchored at the rect origin, focus-peaking
    clamps at its borders); outside it the plain
    :func:`overlays.focus_peaking_planes` rule holds, on both routes.  The
    kernel reads the rect from device memory and clamps it
    (:func:`convert.clamp_rect`), so a (4,) int32 tensor on the planes'
    device, a dynamic ROI, changes no launch; host integers are copied
    there first.
    ``packed_out`` returns (H, W) int32 packed RGBA instead of planes;
    ``outputs`` switches each overlay on or off (None in its place).  ``tm``
    is the zebra clock, a Python float or a 0-d float32 tensor on the
    planes' device, which the kernel reads from device memory (so a CUDA
    graph replays any clock).  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel.
    """
    dev = planes.device
    if dev.type == "cpu":
        return fused_overlays_reference(
            planes, tm, th_low=th_low, th_high=th_high, zb_cs=zb_cs, fc_cs=fc_cs,
            peak_th=peak_th, peak_rgba=tuple(int(c) for c in peak_rgba), rect=rect,
            packed_out=packed_out, outputs=outputs)
    if dev.type != "cuda":
        raise ValueError(f"fused_overlays_planes: unsupported device {dev}")
    tm = clock_tensor(tm, dev)
    h, w = check_overlay_inputs(planes, rect, outputs, tm)
    if rect is not None and not isinstance(rect, torch.Tensor):
        rect = clamp_rect(rect, w, h, dev)
    _, _, op, lp, plan = _launch_args(h, w, th_low, th_high, zb_cs, fc_cs, peak_th,
                                      tuple(peak_rgba), bool(packed_out),
                                      planes.data_ptr() % 16 == 0)
    shape, dtype = ((h, w), torch.int32) if packed_out else ((4, h, w), torch.uint8)
    outs = [torch.empty(shape, dtype=dtype, device=dev) if on else None for on in outputs]
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.ocm_fused_overlays(
            op, lp, planes.data_ptr(), tm.data_ptr(),
            None if rect is None else rect.data_ptr(), _fc_buckets(dev).data_ptr(),
            *(None if t is None else t.data_ptr() for t in outs),
            _kernels.stream_handle(dev),
        )
    fused_overlays_planes.launches += 1
    if rect is not None:
        fused_overlays_planes.launches_rect += 1
    if plan.vec:
        fused_overlays_planes.launches_vec += 1
    _kernels.check(rc, "fused_overlays")
    return tuple(outs)


# every launch; of which with a rect; of which in the 16-byte copy form
# (overlay_plan's ``vec``)
fused_overlays_planes.launches = 0
fused_overlays_planes.launches_rect = 0
fused_overlays_planes.launches_vec = 0
