"""Colour conversion and capture-path ops on torch tensors.

Counterpart of ``obs_color_monitor_tpu/ops/convert.py``.  The JAX module
shapes its formulas around the TPU (u32 bitcasts to avoid lane relayouts,
bf16 one-hot matmuls for the downscale); here each function states the
integer rule of the spec directly (``golden/reference.py``,
``doc/bit-exactness.md``).  Planes are ``(..., C, H, W)`` u8 as in the JAX
package.  A packed frame is the ``(..., H, W)`` 32-bit view of interleaved
RGBA bytes, held as int32: torch's uint32 has no shifts or arithmetic on
the CPU, and ``(x >> 8c) & 255`` takes the same bytes from either sign.

Every public function takes what the JAX function takes: a tensor, or a
host array-like (a numpy array, a JAX array, anything ``np.asarray``
takes), which :func:`_as_device_arg` copies to the default device (a CUDA
GPU when there is one).  A tensor stays where it is and picks the route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..colorspace import FIXED_COEFFS, FIXED_SHIFT, LUMA_COEF, Colorspace


def _default_device() -> str:
    """Where a host array goes without a device named: a CUDA GPU when
    there is one, else the CPU (``ops.fused.default_backend`` names its
    route)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _host_array(a) -> np.ndarray:
    """A caller's host array-like as the C-contiguous numpy array a tensor
    is made from: a uint32 array as its int32 view (the same bytes: torch's
    uint32 has no arithmetic on the CPU, and the port holds packed frames
    as int32), every other dtype kept (uint8 planes, uint16 P010 planes,
    float32 clocks).  A read-only array (a JAX array's host view) is copied
    first, since a tensor made from it could be written.  ``TypeError`` for
    what is not numeric data."""
    arr = np.asarray(a, order="C")
    if arr.dtype.kind not in "biuf":
        raise TypeError(f"expected a tensor or a numeric array, got {type(a).__name__} "
                        f"of dtype {arr.dtype}")
    if not arr.flags.writeable:
        arr = arr.copy()
    return arr.view(np.int32) if arr.dtype == np.uint32 else arr


def _as_device_arg(a, device=None) -> torch.Tensor:
    """The port's one conversion of a caller's array: a tensor is returned
    as it is (the caller checks its device); any other array-like becomes
    :func:`_host_array`'s array on ``device`` (None: the default device,
    :func:`_default_device`), one host-to-device copy."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(_host_array(a)).to(_default_device() if device is None else device)


def planarize(rgba: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 4) u8 -> (..., 4, H, W) u8 (``convert.planarize``)."""
    return _as_device_arg(rgba).movedim(-1, -3).contiguous()


OPAQUE_BLACK = -(1 << 24)  # 0xFF000000 as int32: alpha 255 in the packed view


def as_packed(x: torch.Tensor) -> torch.Tensor:
    """A packed frame as int32: a uint32 tensor is reinterpreted (no copy)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype != torch.int32:
        raise TypeError(f"packed frame must be int32 or uint32, got {x.dtype}")
    return x


def packed_view(frame: torch.Tensor) -> torch.Tensor:
    """The (..., H, W) int32 packed view of an (..., H, W, 4) u8 RGBA frame
    or batch (the same bytes, no copy); a packed frame passes through
    :func:`as_packed`."""
    if frame.ndim >= 3 and frame.shape[-1] == 4 and frame.dtype == torch.uint8:
        return frame.view(torch.int32).squeeze(-1)
    return as_packed(frame)


def rgba_to_packed(rgba: torch.Tensor) -> torch.Tensor:
    """(..., 4) u8 pixels -> their (...) int32 packed view (byte 0 = R), a
    view when they are contiguous.  The flat view first: a size-1 dimension
    may carry any stride, which a dtype view refuses."""
    x = rgba.contiguous()
    return x.reshape(-1).view(torch.int32).view(x.shape[:-1])


def planarize_packed(x32: torch.Tensor) -> torch.Tensor:
    """(..., H, W) packed RGBA -> (..., 4, H, W) u8; byte 0 (R) is the low
    byte (``convert.planarize_packed``)."""
    x = as_packed(_as_device_arg(x32))
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
    return _as_device_arg(planes).movedim(-3, -1)


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
    planes = _as_device_arg(planes)
    r, g, b = _rgb_i32(planes)
    half = 1 << (FIXED_SHIFT - 1)
    outs = [
        ((ki[0] * r + ki[1] * g + ki[2] * b + (ki[3] + half)) >> FIXED_SHIFT)
        .clamp_(0, 255)
        .to(torch.uint8)
        for ki in k
    ]
    return torch.stack(outs, dim=-3)


def rgb_to_yuv_u8(rgba: torch.Tensor, cs: int) -> torch.Tensor:
    """Interleaved wrapper: (..., H, W, 4) u8 -> (..., H, W, 3) u8 Y, U, V
    (``convert.rgb_to_yuv_u8``)."""
    return interleave(rgb_to_yuv_planes(planarize(rgba), cs)).contiguous()


def luma_coef_fixed(cs: int) -> tuple[int, int, int]:
    """Q12 luma coefficients ``round(coef * 2^12)`` for ``cs``."""
    return tuple(int(round(c * (1 << FIXED_SHIFT))) for c in LUMA_COEF[Colorspace(cs)])


def luma_planes(planes: torch.Tensor, cs: int) -> torch.Tensor:
    """Fixed-point luma (scale 255 * 2^12) as int32 (H, W).  The JAX
    function returns the same integers as float32 (``convert.luma_planes``)."""
    kr, kg, kb = luma_coef_fixed(cs)
    r, g, b = _rgb_i32(_as_device_arg(planes))
    return kr * r + kg * g + kb * b


def luma_fixed(rgba: torch.Tensor, cs: int) -> torch.Tensor:
    """Interleaved wrapper of :func:`luma_planes`: (..., H, W, 4) u8 ->
    (..., H, W) int32 (``convert.luma_fixed``, float32 there)."""
    return luma_planes(planarize(rgba), cs)


def downscale_planes(planes: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor pre-downscale on (..., C, H, W) planes.

    The sample position (i + 0.5)*s - 0.5 = i*s + (s-1)/2 gives the rule of
    the spec (``golden/reference.downscale``) for every scale: 1 is the
    identity, an odd scale takes the centre texel, an even scale averages
    the centre 2x2 as ``(a + b + c + d + 2) >> 2``.
    """
    scale = int(scale)
    planes = _as_device_arg(planes)
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


def downscale(rgba: torch.Tensor, scale: int) -> torch.Tensor:
    """Interleaved wrapper of :func:`downscale_planes` (``convert.downscale``);
    scale <= 1 returns the frame as it is."""
    rgba = _as_device_arg(rgba)
    if scale <= 1:
        return rgba
    return interleave(downscale_planes(planarize(rgba), scale)).contiguous()


def roi_crop_planes(planes: torch.Tensor, x0: int, y0: int, x1: int, y1: int) -> torch.Tensor:
    """Static ROI sub-rect on planes (``convert.roi_crop_planes``)."""
    return _as_device_arg(planes)[..., y0:y1, x0:x1]


def roi_crop(rgba: torch.Tensor, x0: int, y0: int, x1: int, y1: int) -> torch.Tensor:
    """Static ROI sub-rect, interleaved (``convert.roi_crop``)."""
    return _as_device_arg(rgba)[..., y0:y1, x0:x1, :]


def clamp_rect(rect, w: int, h: int, device=None) -> torch.Tensor:
    """A dynamic ROI (x0, y0, x1, y1) clamped into a (h, w) frame as the JAX
    dynamic step clamps it (``dock_step.py:495-498``): ``x0 = clip(x0, 0,
    w)``, ``x1 = clip(x1, x0, w)``, the same for y, so a negative or
    reversed x1 gives an empty rect.  ``rect`` is a (4,) integer tensor or
    a host sequence (then copied to ``device``); the result is a (4,)
    int32 tensor on the same device, computed there: the values are never
    read on the host."""
    r = torch.as_tensor(rect, dtype=torch.int32, device=device)
    x0, y0 = r[0].clamp(0, w), r[1].clamp(0, h)
    x1, y1 = torch.maximum(r[2], x0).clamp(max=w), torch.maximum(r[3], y0).clamp(max=h)
    return torch.stack([x0, y0, x1, y1])


def rect_mask(rect_c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h, w) bool: the pixels inside a clamped rect (:func:`clamp_rect`)."""
    ri = torch.arange(h, dtype=torch.int32, device=rect_c.device)[:, None]
    ci = torch.arange(w, dtype=torch.int32, device=rect_c.device)[None, :]
    return (ri >= rect_c[1]) & (ri < rect_c[3]) & (ci >= rect_c[0]) & (ci < rect_c[2])


def nv12_device_planes(y, uv, device="cuda"):
    """(y, uv) NV12 planes on ``device`` with ONE host-to-device copy when
    they are adjacent views of one host buffer (``convert.nv12_device_planes``
    ``:436``).

    NV12 arrives as one contiguous buffer on every wire that carries it (a
    file read, a decoder output), so the planes a caller passes are usually
    adjacent views: the joint (H + H/2, W) block is copied once and split
    by row slices on the device.  Non-adjacent planes (or dtypes other than
    u8 / u16) take two copies; tensors pass through untouched."""
    if isinstance(y, torch.Tensor) and isinstance(uv, torch.Tensor):
        return y, uv
    y, uv = np.asarray(y), np.asarray(uv)
    if (
        y.dtype == uv.dtype
        and y.dtype in (np.uint8, np.uint16)
        and y.ndim == 2
        and uv.ndim == 2
        and y.shape[1] == uv.shape[1]
        and y.flags.c_contiguous
        and uv.flags.c_contiguous
        and y.ctypes.data + y.nbytes == uv.ctypes.data
    ):
        h, w = y.shape
        joint = np.lib.stride_tricks.as_strided(y, shape=(h + uv.shape[0], w), strides=y.strides)
        dev = _as_device_arg(joint, device)
        return dev[:h], dev[h:]
    return _as_device_arg(y, device), _as_device_arg(uv, device)


# NV12 -> RGB: limited-range inverse conversion in 12-bit fixed point, the
# constant table of ``convert._NV12_COEF``/``_NV12_KY`` (csrc/ocm_runtime.cpp
# holds the same): (K_r.Cr, K_g.Cb, K_g.Cr, K_b.Cb) per colorspace.
_NV12_COEF = {
    1: (6537, -1605, -3330, 8263),
    2: (7343, -873, -2183, 8652),
}
_NV12_KY = 4769  # round(255/219 * 4096)


def check_nv12(y: torch.Tensor, uv: torch.Tensor, shift: int = 0) -> None:
    """Raise unless (y, uv) is an NV12 plane pair the decode takes: H and W
    even, ``uv.shape == (H/2, W)``, or a batch of pairs with a leading B on
    both (``ValueError``); u8 planes without
    ``shift``, u16 planes with it (``TypeError``, ``convert.nv12_to_packed``
    ``:410-428``: a forgotten shift on a P010-family buffer must fail, not
    decode raw 16-bit samples)."""
    if shift:
        if y.dtype != torch.uint16 or uv.dtype != torch.uint16:
            raise TypeError(f"shift={shift} expects u16 wire planes, got {y.dtype}/{uv.dtype}")
        if not 1 <= int(shift) <= 8:
            raise ValueError(f"shift must be in 1..8, got {shift}")
    elif y.dtype != torch.uint8 or uv.dtype != torch.uint8:
        raise TypeError(f"NV12 planes must be u8 (pass shift= for 16-bit layouts), "
                        f"got {y.dtype}/{uv.dtype}")
    # (H, W), or a batch (B, H, W) with (B, H/2, W) chroma
    if y.ndim not in (2, 3) or y.shape[-2] % 2 or y.shape[-1] % 2 or tuple(uv.shape) != (
        *y.shape[:-2], y.shape[-2] // 2, y.shape[-1]
    ):
        raise ValueError(f"bad NV12 geometry: y {tuple(y.shape)}, uv {tuple(uv.shape)}")


def _nv12_rgb_u8(y: torch.Tensor, uv: torch.Tensor, cs: int):
    """(H, W) int32 R, G, B planes, 0..255, of an NV12 u8 pair: with
    Y' = Y - 16 and C = Cx - 128, ``clip((4769*Y' + K.C + 2048) >> 12)``
    (``convert._nv12_rgb_u8``; torch's ``>>`` on int32 is arithmetic, so it
    floors as the spec's does).  Chroma sample (row // 2, col & ~1) serves
    the pixel at (row, col)."""
    kr_cr, kg_cb, kg_cr, kb_cb = _NV12_COEF[int(cs)]
    yp = (y.to(torch.int32) - 16) * _NV12_KY
    c = uv.to(torch.int32) - 128
    cb = c[:, 0::2].repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    cr = c[:, 1::2].repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)

    def q(acc):
        return (acc >> 12).clamp_(0, 255)

    return q(yp + kr_cr * cr + 2048), q(yp + kg_cb * cb + kg_cr * cr + 2048), q(
        yp + kb_cb * cb + 2048
    )


def nv12_to_planes(y: torch.Tensor, uv: torch.Tensor, cs: int = 2) -> torch.Tensor:
    """NV12 (y (H, W) u8, uv (H/2, W) u8 interleaved CbCr) -> (4, H, W) u8,
    alpha 255 (``convert.nv12_to_planes``)."""
    y = _as_device_arg(y)
    uv = _as_device_arg(uv, y.device)
    check_nv12(y, uv)
    r, g, b = _nv12_rgb_u8(y, uv, cs)
    a = torch.full_like(r, 255)
    return torch.stack([r, g, b, a]).to(torch.uint8)


def nv12_packed_reference(y: torch.Tensor, uv: torch.Tensor, cs: int = 2) -> torch.Tensor:
    """Plain version of kernel K4: NV12 u8 planes -> the (H, W) int32 packed
    RGBA view ``r | g << 8 | b << 16 | 0xFF000000``; a batch frame by
    frame, (B, H, W) out."""
    check_nv12(y, uv)
    if y.ndim == 3:
        return torch.stack([nv12_packed_reference(a, b, cs) for a, b in zip(y, uv)])
    return _pack_rgb(*_nv12_rgb_u8(y, uv, cs))


def _pack_rgb(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return r | (g << 8) | (b << 16) | OPAQUE_BLACK


def _shift16_to_u8(plane: torch.Tensor, shift: int) -> torch.Tensor:
    """The ingest round-shift of a 16-bit sample to 8 bits,
    ``min((v + half) >> shift, 255)`` (``convert._shift16_to_u8``).  Torch's
    uint16 has no arithmetic, so the samples widen to int32 first, through
    their int16 view (which every device converts)."""
    v = ((plane.view(torch.int16).to(torch.int32) & 0xFFFF) + (1 << (shift - 1))) >> shift
    return v.clamp_(max=255).to(torch.uint8)


def nv12_16_packed_reference(
    y16: torch.Tensor, uv16: torch.Tensor, cs: int = 2, shift: int = 2
) -> torch.Tensor:
    """Plain version of kernel K5: P010-family u16 planes, round-shifted to
    8 bits, then the K4 decode (``convert._nv12_16_to_packed_xla``); a
    batch frame by frame."""
    check_nv12(y16, uv16, shift)
    if y16.ndim == 3:
        return torch.stack([nv12_16_packed_reference(a, b, cs, shift)
                            for a, b in zip(y16, uv16)])
    return _pack_rgb(*_nv12_rgb_u8(_shift16_to_u8(y16, shift), _shift16_to_u8(uv16, shift), cs))


def nv12_shift(bits: int, msb_aligned: bool = False) -> int:
    """Round-shift from a 16-bit-LE NV12-layout sample to the 8-bit
    monitoring domain (``convert.nv12_shift``): bits-8 for LSB-aligned
    p10/p12/p14/p16 samples, 8 for MSB-aligned P010, 0 for 8-bit NV12."""
    if bits not in (8, 10, 12, 14, 16):
        raise ValueError(f"bits must be 8/10/12/14/16, got {bits}")
    if bits == 8:
        return 0
    return 8 if msb_aligned else bits - 8


def nv12_to_packed(
    y: torch.Tensor, uv: torch.Tensor, cs: int = 2, shift: int = 0
) -> torch.Tensor:
    """NV12 -> the (H, W) int32 packed-RGBA view, decoded on the planes'
    device (``convert.nv12_to_packed``); a batch of (B, H, W) and
    (B, H/2, W) planes decodes in one launch to (B, H, W).  ``shift`` > 0
    takes P010-family u16 planes and fuses the round-shift into the decode
    (:func:`nv12_shift`).  Kernel K5 runs for ``shift`` > 0, K4 otherwise
    (``ops/decode.py``), each checking its planes; a CPU tensor runs their
    plain versions."""
    from .decode import nv12_16_decode, nv12_decode

    y = _as_device_arg(y)
    uv = _as_device_arg(uv, y.device)
    if shift:
        return nv12_16_decode(y, uv, cs=cs, shift=shift)
    return nv12_decode(y, uv, cs=cs)
