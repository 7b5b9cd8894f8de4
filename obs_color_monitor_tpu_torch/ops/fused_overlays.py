"""Zebra, false colour and focus peaking in one pass: the wrapper of kernel
K3 and its plain version.

Counterpart of ``obs_color_monitor_tpu/ops/pallas_overlays.py``
(``fused_overlays_planes`` ``:208``, kernel ``_ov_kernel`` ``:173``).  The
plain version composes the three overlay ops of ``ops/overlays.py``; the
CUDA source is ``ops/csrc/fused_overlays.cu``, which shares its per-pixel
math with K1's overlay launch (``ops/csrc/overlay_math.cuh``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from . import overlays as ov
from .convert import clamp_rect, interleave, rgba_to_packed
from .pipeline import _overlay_params

ALL = (True, True, True)


def packed_from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(4, H, W) u8 -> the (H, W) int32 packed view of its RGBA bytes
    (byte 0 = R), as the kernel's ``packed_out`` composes it."""
    return rgba_to_packed(interleave(planes))


def _tm_rect(tm: float, rect_c: torch.Tensor | None, device) -> torch.Tensor:
    """The zebra clock with its phase anchored at the clamped rect's origin:
    ``tm - (x0 + y0)``, one float32 subtraction, as the JAX kernel and
    dynamic dock compute it (``pallas_overlays.py:81``)."""
    tm32 = torch.tensor(np.float32(tm), device=device)
    return tm32 if rect_c is None else tm32 - (rect_c[0] + rect_c[1]).to(torch.float32)


def fused_overlays_reference(
    planes: torch.Tensor,
    tm: float,
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


def fused_overlays_planes(
    planes: torch.Tensor,
    tm: float,
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
    ``outputs`` switches each overlay on or off (None in its place).  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    peak_rgba = tuple(int(c) for c in peak_rgba)
    kw = dict(th_low=th_low, th_high=th_high, zb_cs=zb_cs, fc_cs=fc_cs, peak_th=peak_th,
              peak_rgba=peak_rgba, rect=rect, packed_out=packed_out, outputs=outputs)
    if planes.device.type == "cpu":
        return fused_overlays_reference(planes, tm, **kw)
    if planes.device.type != "cuda":
        raise ValueError(f"fused_overlays_planes: unsupported device {planes.device}")
    if planes.ndim != 3 or planes.shape[0] != 4 or planes.dtype != torch.uint8:
        raise ValueError(f"planes must be (4, H, W) u8, got {tuple(planes.shape)} {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("fused_overlays_planes: the planes must be contiguous")
    if not any(outputs):
        raise ValueError("fused_overlays_planes: no output enabled")
    h, w = planes.shape[1], planes.shape[2]
    if isinstance(rect, torch.Tensor):
        if rect.dtype != torch.int32 or rect.shape != (4,) or not rect.is_contiguous():
            raise ValueError(f"rect must be a contiguous (4,) int32 tensor, got "
                             f"{tuple(rect.shape)} {rect.dtype}")
        if rect.device != planes.device:
            raise ValueError(f"rect on {rect.device}, the planes on {planes.device}")
    elif rect is not None:
        rect = clamp_rect(rect, w, h, planes.device)
    shape, dtype = ((h, w), torch.int32) if packed_out else ((4, h, w), torch.uint8)
    outs = [torch.empty(shape, dtype=dtype, device=planes.device) if on else None
            for on in outputs]
    op = _overlay_params(h, w, float(th_low), float(th_high), int(zb_cs), int(fc_cs),
                         int(peak_th), peak_rgba)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _kernels.library()
    with torch.cuda.device(planes.device):
        rc = lib.ocm_fused_overlays(
            ctypes.addressof(op), planes.data_ptr(), float(np.float32(tm)), ptr(rect),
            int(packed_out), *(ptr(t) for t in outs),
            _kernels.stream_handle(planes.device),
        )
    fused_overlays_planes.launches += 1
    if rect is not None:
        fused_overlays_planes.launches_rect += 1
    _kernels.check(rc, "fused_overlays")
    return tuple(outs)


# every launch; of which with a rect
fused_overlays_planes.launches = 0
fused_overlays_planes.launches_rect = 0
