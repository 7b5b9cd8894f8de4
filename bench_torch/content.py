"""Seeded camera-like NV12 frames, made on the device.

A scope's speed depends on what it counts: camera pictures pile into a few
vectorscope and histogram bins (sky, skin, foliage), where uniform noise
spreads every count evenly.  So a frame here is a panned scene: a sky
gradient with a clipped sun (zebra, the top false-colour bands), foliage
over the program's ramp, a skin-toned face, a band of the program's moving
colour bars and one of its zone plate (focus peaking), and a little grain.
The bars, ramp and zone-plate definitions are copies of
``runtime.native.pattern``'s NumPy ones.  Everything is drawn from one
``torch.Generator`` on the device, in float32, then encoded as BT.709 or
BT.601 limited-range NV12 and copied to pageable host memory as one
(H * 3 / 2, W) buffer per frame, as a decoder hands a frame over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_KRB = {"bt601": (0.299, 0.114), "bt709": (0.2126, 0.0722)}
BARS = ((191, 191, 191), (191, 191, 0), (0, 191, 191), (0, 191, 0),
        (191, 0, 191), (191, 0, 0), (0, 0, 191), (0, 0, 0))


def bars(w: int, offset: int, device) -> torch.Tensor:
    """(W, 3) float rows of the 8 colour bars, shifted by ``offset`` pixels."""
    idx = ((torch.arange(w, device=device) + offset) % w) * 8 // w
    return torch.tensor(BARS, dtype=torch.float32, device=device)[idx] / 255.0


def ramp(h: int, w: int, frame_idx: int, device) -> torch.Tensor:
    """(H, W, 3) float ramp pattern: R by column, B by row, G their mean."""
    v = torch.arange(w, device=device) * 256 // w
    t = (torch.arange(h, device=device) + frame_idx) * 256 // h
    out = torch.empty((h, w, 3), device=device)
    out[..., 0] = v.clamp(0, 255)[None, :]
    out[..., 1] = torch.div(v[None, :] + t[:, None], 2, rounding_mode="floor").clamp(0, 255)
    out[..., 2] = t.clamp(0, 255)[:, None]
    return out / 255.0


def zoneplate(h: int, w: int, frame_idx: int, device) -> torch.Tensor:
    """(H, W) float zone plate ``0.5 + 0.5 cos(k r^2 / 100)`` about the centre."""
    k = 0.05 + 0.0005 * (frame_idx % 100)
    xx = torch.arange(w, dtype=torch.float64, device=device) - w / 2.0
    yy = torch.arange(h, dtype=torch.float64, device=device) - h / 2.0
    r2 = xx[None, :] ** 2 + yy[:, None] ** 2
    return (0.5 + 0.5 * torch.cos(k * r2 / 100.0)).to(torch.float32)


def scene(h: int, w: int, frame_idx: int, gen: torch.Generator, device) -> torch.Tensor:
    """One (H, W, 3) float RGB picture in [0, 1], its parameters drawn from ``gen``."""

    def u(lo, hi):
        return lo + (hi - lo) * float(torch.rand((), generator=gen, device=device))

    pan = int(u(0, w))  # a different pan offset each frame
    xs = (torch.arange(w, dtype=torch.float32, device=device) + pan) / w
    ys = torch.arange(h, dtype=torch.float32, device=device) / h
    img = torch.empty((h, w, 3), device=device)
    horizon = int(h * u(0.38, 0.5))
    # sky: blue at the top, paler toward the horizon, a clipped sun
    t = (ys[:horizon] / max(ys[horizon - 1].item(), 1e-6))[:, None]
    sky_top = torch.tensor([u(0.15, 0.3), u(0.35, 0.5), u(0.75, 0.95)], device=device)
    sky_low = torch.tensor([u(0.6, 0.75), u(0.75, 0.85), u(0.9, 1.0)], device=device)
    img[:horizon] = (sky_top + (sky_low - sky_top) * t[..., None]).expand(horizon, w, 3)
    sx, sy, sr = u(0.1, 0.9), u(0.05, 0.25), u(0.03, 0.06)
    d = ((xs[None, :] % 1.0 - sx) * w / h) ** 2 + (ys[:horizon, None] - sy) ** 2
    img[:horizon] = torch.where((d < sr * sr)[..., None], torch.full_like(img[:horizon], 1.02),
                                img[:horizon])
    # foliage over the ramp, shaded across the pan
    ground = ramp(h - horizon, w, frame_idx, device)
    green = torch.tensor([u(0.15, 0.3), u(0.35, 0.55), u(0.1, 0.2)], device=device)
    shade = (0.75 + 0.25 * torch.sin(2 * math.pi * xs))[None, :, None]
    img[horizon:] = (0.8 * green + 0.2 * ground) * shade
    # a face: skin tones lit from one side
    fx, fy = u(0.2, 0.8), u(0.55, 0.7)
    fr = u(0.12, 0.2)
    dx = (xs[None, :] % 1.0 - fx) * w / h
    dy = ys[:, None] - fy
    face = (dx / 0.75) ** 2 + dy ** 2 < fr * fr
    skin = torch.tensor([u(0.78, 0.92), u(0.55, 0.68), u(0.45, 0.56)], device=device)
    light = (0.85 + 0.3 * dx / fr).clamp(0.6, 1.1)[..., None]
    img = torch.where(face[..., None], skin * light, img)
    # the moving bars and the zone plate, low in the picture
    b0, b1 = int(h * 0.8), int(h * 0.88)
    img[b0:b1] = bars(w, pan, device)[None]
    img[b1:] = zoneplate(h - b1, w, frame_idx, device)[..., None].expand(-1, w, 3)
    img += torch.randn(img.shape, generator=gen, device=device) * (1.5 / 255.0)
    return img.clamp(0.0, 1.08)


def encode_nv12(rgb: torch.Tensor, colorspace: str) -> torch.Tensor:
    """(H, W, 3) float RGB -> one (H * 3 / 2, W) u8 NV12 buffer, limited
    range (Y 16..235, C 16..240 nominal; over-range values kept up to the
    code limits), chroma the mean of each 2x2 block."""
    kr, kb = _KRB[colorspace]
    kg = 1.0 - kr - kb
    r, g, b = rgb.unbind(-1)
    yl = kr * r + kg * g + kb * b
    cb = (b - yl) / (2 * (1 - kb))
    cr = (r - yl) / (2 * (1 - kr))
    h, w = yl.shape

    def sub(c):
        return c.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))

    y8 = torch.round(16 + 219 * yl).clamp(1, 254)
    uv = torch.stack([torch.round(128 + 224 * sub(cb)), torch.round(128 + 224 * sub(cr))], -1)
    return torch.cat([y8, uv.clamp(1, 254).reshape(h // 2, w)]).to(torch.uint8)


def frame_pool(seed: int, stream: int, n: int, height: int, width: int, colorspace: str,
               device) -> list[np.ndarray]:
    """``n`` distinct NV12 frames of one stream, as host buffers."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    out = []
    for i in range(n):
        buf = encode_nv12(scene(height, width, i, gen, device), colorspace)
        out.append(buf.cpu().numpy())
    return out
