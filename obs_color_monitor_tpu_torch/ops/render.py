"""Scope renderers: counts -> RGBA images, on torch tensors.

Counterpart of ``obs_color_monitor_tpu/ops/render.py`` (the draw shaders
``data/vectorscope.effect``, ``data/waveform.effect``,
``data/histogram.effect``).  Tints are Q12 integers and the histogram fill
test is one float32 multiply, so the images are the same on every device.
In YUV mode display channel i reads count channel ``DISP_YUV[i]`` (the
reference's BGRA staging order); the spec is ``golden/render.py``.  A host
array-like input goes to the default device (``convert._as_device_arg``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..colorspace import VECTORSCOPE_TINT, Colorspace
from ..config import DisplayMode
from ..golden import render as golden_render
from .convert import OPAQUE_BLACK, _as_device_arg

DISP_RGB, DISP_YUV = golden_render.DISP_RGB, golden_render.DISP_YUV
TINT_Q12, TINT_U8 = golden_render.TINT_Q12, golden_render.TINT_U8

VS_SIZE = 256


def _compose_rgba(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Three (H, W) int32 planes with values 0..255 -> (H, W, 4) u8, alpha
    255: one int32 compose, then a little-endian byte view."""
    x = r | (g << 8) | (b << 16) | OPAQUE_BLACK
    return x.contiguous().view(torch.uint8).view(*x.shape, 4)


def render_vectorscope(
    counts: torch.Tensor, intensity: int, cs: int, white: bool
) -> torch.Tensor:
    """counts (256, 256) u8 [v, u] ascending -> RGBA (256, 256, 4); row 0 is
    v = 255 (``render.render_vectorscope``).  The chroma tint
    ``(C*256 + Cu*(2u+1-256) + Cv*(256-(2v+1))) * level`` is Q20 and rounds
    with an arithmetic shift of the (possibly negative) int32."""
    counts = _as_device_arg(counts)
    v = (counts.flip(0).to(torch.int32) * int(intensity)).clamp(max=255)
    if white:
        return _compose_rgba(v, v, v)
    tint = VECTORSCOPE_TINT[Colorspace(cs)]
    C = np.round(np.asarray(tint["color"][:3]) * 4096).astype(np.int64)
    Cu = np.round(np.asarray(tint["color_u"]) * 4096).astype(np.int64)
    Cv = np.round(np.asarray(tint["color_v"]) * 4096).astype(np.int64)
    idx = torch.arange(VS_SIZE, dtype=torch.int32, device=counts.device)
    fu = (2 * idx + 1 - 256)[None, :]
    fv = (256 - (2 * idx + 1))[:, None]
    chans = []
    for c in range(3):
        num = int(C[c]) * 256 + int(Cu[c]) * fu + int(Cv[c]) * fv  # Q20
        chans.append(((num * v + (1 << 19)) >> 20).clamp_(0, 255))
    return _compose_rgba(*chans)


def _disp_order(yuv_mode: bool) -> tuple[int, int, int]:
    return DISP_YUV if yuv_mode else DISP_RGB


def _reorder(x: torch.Tensor, yuv_mode: bool) -> torch.Tensor:
    """The channels of ``x`` in display order.  Stacked from the channels
    themselves: an index list would cross from the host on every call (and
    a CUDA graph cannot capture that copy)."""
    return torch.stack([x[i] for i in _disp_order(yuv_mode)])


def _bands(n_components: int) -> tuple[int, ...]:
    return (0, 1, 2) if n_components == 3 else (0, 2)


def render_waveform(
    counts: torch.Tensor,
    intensity: int,
    display: int,
    n_components: int,
    yuv_mode: bool,
) -> torch.Tensor:
    """counts (3, 256, W) u8 ascending -> RGBA image
    (``render.render_waveform``): OVERLAY maps each display channel to
    ``min(count * intensity, 255)``; STACK/PARADE tile Q12-tinted bands
    vertically/horizontally (n = 2 shows bands 0 and 2; n = 1 is OVERLAY)."""
    vals = (_reorder(_as_device_arg(counts), yuv_mode).flip(1).to(torch.int32) * int(intensity)).clamp(max=255)
    if n_components <= 1 or DisplayMode(display) == DisplayMode.OVERLAY:
        return _compose_rgba(vals[0], vals[1], vals[2])
    dim = 0 if DisplayMode(display) == DisplayMode.STACK else 1
    chans = [
        torch.cat(
            [
                ((vals[b] * int(TINT_Q12[b, c]) + 2048) >> 12).clamp_(0, 255)
                for b in _bands(n_components)
            ],
            dim=dim,
        )
        for c in range(3)
    ]
    return _compose_rgba(*chans)


def render_histogram(
    levels: torch.Tensor,
    hi_max: torch.Tensor,
    level_height: int,
    display: int,
    n_components: int,
    yuv_mode: bool,
) -> torch.Tensor:
    """levels (3, 256) f32 + hi_max (3,) f32 -> RGBA bars
    (``render.render_histogram``): a pixel is filled where
    ``level >= (1 - (row + 0.5) / H) * hi_max``, all in float32."""
    H = int(level_height)
    levels = _as_device_arg(levels)
    hi_max = _as_device_arg(hi_max, levels.device)
    lv = _reorder(levels, yuv_mode).to(torch.float32)
    hm = _reorder(hi_max, yuv_mode).to(torch.float32)
    rows = torch.arange(H, dtype=torch.float32, device=levels.device)
    # a tensor divisor: divided by a host scalar, CUDA multiplies by its
    # rounded reciprocal, which differs from the true quotient by an ulp at
    # some rows and flips the fill at exact ties (count * 2H == (2H - 2 row
    # - 1) * hi_max); the CPU divides, as golden does
    thr = (1.0 - (rows + 0.5) / torch.full_like(rows, float(H)))[:, None]  # (H, 1)
    fill = lv[:, None, :] >= thr[None] * hm[:, None, None]  # (3, H, 256)
    zero = torch.zeros((), dtype=torch.int32, device=levels.device)
    if n_components <= 1 or DisplayMode(display) == DisplayMode.OVERLAY:
        on = [torch.where(fill[c], 255, zero) for c in range(3)]
        return _compose_rgba(*on)
    dim = 0 if DisplayMode(display) == DisplayMode.STACK else 1
    chans = [
        torch.cat(
            [torch.where(fill[b], int(TINT_U8[b, c]), zero) for b in _bands(n_components)],
            dim=dim,
        )
        for c in range(3)
    ]
    return _compose_rgba(*chans)


def _blend(src: torch.Tensor, alpha: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``(s*a + d*(255-a) + 127) // 255`` in int32, back to u8."""
    a = alpha.to(torch.int32)
    return ((src.to(torch.int32) * a + dst.to(torch.int32) * (255 - a) + 127) // 255).to(
        torch.uint8
    )


def blend_overlay(image: torch.Tensor, overlay: torch.Tensor) -> torch.Tensor:
    """Integer srcalpha/invsrcalpha blend of an (H, W, 4) u8 overlay onto an
    (H, W, 4) u8 image; the image's alpha passes through
    (``render.blend_overlay``, the device twin of ``utils.draw.alpha_blend_u8``)."""
    image = _as_device_arg(image)
    overlay = _as_device_arg(overlay, image.device)
    rgb = _blend(overlay[..., :3], overlay[..., 3:4], image[..., :3])
    return torch.cat([rgb, image[..., 3:]], dim=-1)


def blend_overlay_planes(planes: torch.Tensor, overlay_planes: torch.Tensor) -> torch.Tensor:
    """Planar twin of :func:`blend_overlay`: (4, H, W) image and overlay
    (``render.blend_overlay_planes``)."""
    planes = _as_device_arg(planes)
    overlay_planes = _as_device_arg(overlay_planes, planes.device)
    rgb = _blend(overlay_planes[:3], overlay_planes[3:4], planes[:3])
    return torch.cat([rgb, planes[3:]], dim=0)


def zoom_center(image: torch.Tensor, zoom: float) -> torch.Tensor:
    """Vectorscope zoom about the centre (``render.zoom_center``): scale by
    ``zoom`` with offset 127.5 * (1 - zoom), point-sampled through a host
    index map."""
    image = _as_device_arg(image)
    if zoom <= 1.01:
        return image
    idx = _zoom_index(image.shape[0], float(zoom), image.device)
    return image.index_select(0, idx).index_select(1, idx)


@functools.lru_cache(maxsize=64)
def _zoom_index(n: int, zoom: float, device: torch.device) -> torch.Tensor:
    """The source row/column of each of ``n`` zoomed samples, on ``device``
    (built once per zoom: no host copy per frame)."""
    ofst = (n / 2 - 0.5) * (1.0 - zoom)
    src = np.clip(np.floor((np.arange(n) + 0.5 - ofst) / zoom).astype(np.int64), 0, n - 1)
    return torch.as_tensor(src, device=device)
