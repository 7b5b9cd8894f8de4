"""Colour conversion and capture-path ops on torch tensors.

Counterpart of ``obs_color_monitor_tpu/ops/convert.py``.  The JAX module
shapes its formulas around the TPU (u32 bitcasts to avoid lane relayouts,
bf16 one-hot matmuls for the downscale); here each function states the
integer rule of the spec directly (``golden/reference.py``,
``doc/bit-exactness.md``).  Planes are ``(..., C, H, W)`` u8 as in the JAX
package.  A packed frame is the ``(..., H, W)`` 32-bit view of interleaved
RGBA bytes, held as int32: torch's uint32 has no shifts or arithmetic on
the CPU, and ``(x >> 8c) & 255`` takes the same bytes from either sign.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spec import FIXED_COEFFS, FIXED_SHIFT, LUMA_COEF, Colorspace


def planarize(rgba: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 4) u8 -> (..., 4, H, W) u8 (``convert.planarize``)."""
    return rgba.movedim(-1, -3).contiguous()


def as_packed(x: torch.Tensor) -> torch.Tensor:
    """A packed frame as int32: a uint32 tensor is reinterpreted (no copy)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype != torch.int32:
        raise TypeError(f"packed frame must be int32 or uint32, got {x.dtype}")
    return x


def planarize_packed(x32: torch.Tensor) -> torch.Tensor:
    """(..., H, W) packed RGBA -> (..., 4, H, W) u8; byte 0 (R) is the low
    byte (``convert.planarize_packed``)."""
    x = as_packed(x32)
    return torch.stack([((x >> k) & 255).to(torch.uint8) for k in (0, 8, 16, 24)], dim=-3)


def host_packed_view(frame):
    """Host (H, W, 4) u8 C-contiguous frame -> its (H, W) int32 packed view
    (the same bytes, a free numpy view); anything else passes through
    (``convert.host_packed_view``, which returns the u32 view)."""
    if (
        isinstance(frame, np.ndarray)
        and frame.ndim == 3
        and frame.shape[-1] == 4
        and frame.dtype == np.uint8
        and frame.flags["C_CONTIGUOUS"]
    ):
        return frame.view(np.int32).reshape(frame.shape[:2])
    return frame


def interleave(planes: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) -> (..., H, W, C) (``convert.interleave``)."""
    return planes.movedim(-3, -1)


def planes_to_rgba(planes: torch.Tensor) -> torch.Tensor:
    """(4, H, W) u8 -> (H, W, 4) u8, contiguous (``convert.planes_to_rgba``)."""
    return interleave(planes).contiguous()


def _rgb_i32(planes: torch.Tensor):
    return [planes[..., c, :, :].to(torch.int32) for c in range(3)]


def rgb_to_yuv_planes(planes: torch.Tensor, cs: int) -> torch.Tensor:
    """Q12 RGB->YUV: (..., C>=3, H, W) u8 -> (..., 3, H, W) u8 in Y, U, V
    order; ``clip((K.rgb + O + 2^11) >> 12, 0, 255)`` with ``FIXED_COEFFS``
    (``convert.rgb_to_yuv_planes``)."""
    k = FIXED_COEFFS[Colorspace(cs)].tolist()
    r, g, b = _rgb_i32(planes)
    half = 1 << (FIXED_SHIFT - 1)
    outs = [
        ((ki[0] * r + ki[1] * g + ki[2] * b + (ki[3] + half)) >> FIXED_SHIFT)
        .clamp_(0, 255)
        .to(torch.uint8)
        for ki in k
    ]
    return torch.stack(outs, dim=-3)


def luma_coef_fixed(cs: int) -> tuple[int, int, int]:
    """Q12 luma coefficients ``round(coef * 2^12)`` for ``cs``."""
    return tuple(int(round(c * (1 << FIXED_SHIFT))) for c in LUMA_COEF[Colorspace(cs)])


def luma_planes(planes: torch.Tensor, cs: int) -> torch.Tensor:
    """Fixed-point luma (scale 255 * 2^12) as int32 (H, W).  The JAX
    function returns the same integers as float32 (``convert.luma_planes``)."""
    kr, kg, kb = luma_coef_fixed(cs)
    r, g, b = _rgb_i32(planes)
    return kr * r + kg * g + kb * b


def downscale_planes(planes: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor pre-downscale on (..., C, H, W) planes.

    The sample position (i + 0.5)*s - 0.5 = i*s + (s-1)/2 gives the rule of
    the spec (``golden/reference.downscale``) for every scale: 1 is the
    identity, an odd scale takes the centre texel, an even scale averages
    the centre 2x2 as ``(a + b + c + d + 2) >> 2``.
    """
    scale = int(scale)
    if scale <= 1:
        return planes
    h, w = planes.shape[-2], planes.shape[-1]
    oh, ow = h // scale, w // scale
    if oh == 0 or ow == 0:
        raise ValueError(f"frame {w}x{h} too small for scale {scale}")
    x = planes[..., : oh * scale, : ow * scale]
    if scale % 2:
        m = (scale - 1) // 2
        return x[..., m::scale, m::scale].contiguous()
    a = scale // 2 - 1
    s = sum(
        x[..., a + dy :: scale, a + dx :: scale].to(torch.int32)
        for dy in (0, 1)
        for dx in (0, 1)
    )
    return ((s + 2) >> 2).to(torch.uint8)


def roi_crop_planes(planes: torch.Tensor, x0: int, y0: int, x1: int, y1: int) -> torch.Tensor:
    """Static ROI sub-rect on planes (``convert.roi_crop_planes``)."""
    return planes[..., y0:y1, x0:x1]
