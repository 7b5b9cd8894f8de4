"""Overlay scopes on planar frames: zebra, false colour, focus peaking.

Counterpart of ``obs_color_monitor_tpu/ops/overlays.py``.  Planar
(4, H, W) u8 in, (4, H, W) u8 out.  Luma and thresholds are the spec's
integers (the JAX module carries them as integer-valued float32); only the
zebra stripe phase is float32, as in the shader.  These are the plain
versions of the overlay half of the frame-pipeline kernel K1 and of the
overlay kernel K3 (``ops/fused_overlays.py``), whose shared per-pixel math
is ``ops/csrc/overlay_math.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..golden.reference import (
    FALSECOLOR_BANDS,
    falsecolor_band_colors_u8,
    luma_threshold_fixed,
)
from .convert import clamp_rect, luma_planes

BAND_COLORS = falsecolor_band_colors_u8()  # (12, 4) u8
BAND_THRESH = tuple(luma_threshold_fixed(t) for t, _ in FALSECOLOR_BANDS[:-1])  # (11,)


def zebra_planes(
    planes: torch.Tensor, th_low: float, th_high: float, tm: float, cs: int
) -> torch.Tensor:
    """Diagonal stripes where th_low <= luma <= th_high and
    ``floor(x + y + 1 + tm) mod 6 < 3``; striped pixels become opaque black
    (``overlays.zebra_planes``).  The phase is float32 (``x + y + 1`` is
    exact there) with the floored modulo of JAX's ``%``.  ``tm`` is a
    Python float or a 0-d float32 tensor on the planes' device."""
    luma = luma_planes(planes, cs)
    h, w = planes.shape[-2], planes.shape[-1]
    yy = torch.arange(h, dtype=torch.float32, device=planes.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=planes.device)[None, :]
    if isinstance(tm, torch.Tensor):
        tm32 = tm.to(torch.float32)
    else:
        tm32 = torch.tensor(np.float32(tm), device=planes.device)
    phase = torch.floor(xx + yy + 1.0 + tm32).to(torch.int32).remainder(6)
    stripe = (
        (luma >= luma_threshold_fixed(th_low))
        & (luma <= luma_threshold_fixed(th_high))
        & (phase < 3)
    )
    rgb = torch.where(stripe, 0, planes[..., :3, :, :])
    return torch.cat([rgb, torch.where(stripe, 255, planes[..., 3:, :, :])], dim=-3)


def falsecolor_planes(planes: torch.Tensor, cs: int) -> torch.Tensor:
    """12-band false colour: the band is the first whose upper bound the
    luma is below (``overlays.falsecolor_planes``)."""
    luma = luma_planes(planes, cs)
    thresh = torch.tensor(BAND_THRESH, dtype=torch.int32, device=planes.device)
    band = torch.bucketize(luma, thresh, right=True)  # count of bounds <= luma
    colors = torch.as_tensor(BAND_COLORS, device=planes.device)
    return colors[band].movedim(-1, -3).contiguous()


def falsecolor_lut_planes(
    planes: torch.Tensor, lut: torch.Tensor, cs: int, lut_n: int
) -> torch.Tensor:
    """User LUT false colour, point-sampled with clamp:
    ``i = clip(luma * N // (255 * 2^12), 0, N-1)``, in int64 (the JAX
    module splits the division to stay inside int32)
    (``overlays.falsecolor_lut_planes``).  lut is (N, 4) u8."""
    if lut_n > 32768:
        raise ValueError("falsecolor LUT larger than 32768 entries")
    luma = luma_planes(planes, cs).to(torch.int64)
    i = torch.clamp((luma * lut_n) // (255 << 12), 0, lut_n - 1)
    lut = torch.as_tensor(lut, dtype=torch.uint8, device=planes.device)
    return lut[i].movedim(-1, -3).contiguous()


def focus_peaking_planes(
    planes: torch.Tensor, th_fixed: int, peaking_color_u8, rect=None
) -> torch.Tensor:
    """4-neighbour edge highlight: the sum over RGB and the +-x/+-y cross of
    |neighbour - centre| with edge clamp (a clamped neighbour adds 0),
    compared with the integer ``th_fixed``; peaks take the peaking colour
    (``overlays.focus_peaking_planes``).

    ``rect`` (x0, y0, x1, y1), host integers or a (4,) integer tensor (a
    dynamic ROI, clamped on its device by :func:`convert.clamp_rect`): the
    edge clamps move to the rect borders, so pixels inside it equal the
    focus peaking of the cropped frame.  Outside it the JAX function's rule
    holds as well: the right/lower difference is cut at x1-1/y1-1 and the
    left/upper one at x0/y0."""
    rgb = planes[..., :3, :, :].to(torch.int32)
    h, w = rgb.shape[-2], rgb.shape[-1]
    zeros = lambda: torch.zeros((h, w), dtype=torch.int32, device=planes.device)
    dxf, dyf = zeros(), zeros()  # forward differences, 0 at the last column/row
    dxf[:, :-1] = (rgb[..., :, 1:] - rgb[..., :, :-1]).abs().sum(dim=-3)
    dyf[:-1, :] = (rgb[..., 1:, :] - rgb[..., :-1, :]).abs().sum(dim=-3)
    if rect is not None:
        x0, y0, x1, y1 = clamp_rect(rect, w, h, planes.device)
        ci = torch.arange(w, dtype=torch.int32, device=planes.device)[None, :]
        ri = torch.arange(h, dtype=torch.int32, device=planes.device)[:, None]
        dxf = torch.where(ci >= x1 - 1, 0, dxf)
        dyf = torch.where(ri >= y1 - 1, 0, dyf)
    sxr, syr = zeros(), zeros()  # the left / upper neighbour's difference
    sxr[:, 1:] = dxf[:, :-1]
    syr[1:, :] = dyf[:-1, :]
    if rect is not None:
        sxr = torch.where(ci <= x0, 0, sxr)
        syr = torch.where(ri <= y0, 0, syr)
    acc = dxf + sxr + dyf + syr
    peak = acc >= int(th_fixed)
    color = [int(c) for c in np.asarray(peaking_color_u8, np.uint8)]
    return torch.stack([torch.where(peak, color[c], planes[..., c, :, :]) for c in range(4)],
                       dim=-3)
