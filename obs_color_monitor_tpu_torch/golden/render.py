"""Golden renderers: literal per-pixel ports of the draw shaders.

Copied whole from ``obs_color_monitor_tpu/golden/render.py`` so that the
torch port imports nothing of the JAX package.

Complements golden/reference.py (the accumulator oracle) with the display
side: the vectorscope/waveform/histogram draw techniques
(reference data/vectorscope.effect:27-33, data/waveform.effect:30-83,
data/histogram.effect:30-85), restated in this framework's integer
canonicalization (Q12 tints, single-f32-multiply fill tests) so device
renders can be tested bit-for-bit for every display/component combination.
"""

from __future__ import annotations

import numpy as np

from ..colorspace import Colorspace, VECTORSCOPE_TINT

# Stack/parade band tint rows (reference waveform.effect:4-9).
TINT_ROWS = np.asarray(
    [[1.00, 0.41, 0.41], [0.00, 1.00, 0.00], [0.53, 0.53, 1.00]], dtype=np.float64
)
TINT_Q12 = np.round(TINT_ROWS * 4096.0).astype(np.int64)
TINT_U8 = np.floor(np.clip(TINT_ROWS, 0, 1) * 255.0 + 0.5).astype(np.uint8)

DISP_RGB = (0, 1, 2)
DISP_YUV = (2, 0, 1)  # display channel i reads count channel DISP[i]


def render_vectorscope(
    counts: np.ndarray, intensity: int, cs: Colorspace, white: bool
) -> np.ndarray:
    """counts (256,256) u8 [v,u] ascending -> RGBA (256,256,4)."""
    v = np.minimum(counts[::-1].astype(np.int64) * int(intensity), 255)
    out = np.empty((256, 256, 4), np.uint8)
    out[..., 3] = 255
    if white:
        out[..., 0] = out[..., 1] = out[..., 2] = v.astype(np.uint8)
        return out
    tint = VECTORSCOPE_TINT[Colorspace(cs)]
    C = np.round(np.asarray(tint["color"][:3]) * 4096).astype(np.int64)
    Cu = np.round(np.asarray(tint["color_u"]) * 4096).astype(np.int64)
    Cv = np.round(np.asarray(tint["color_v"]) * 4096).astype(np.int64)
    col = np.arange(256)[None, :]
    row = np.arange(256)[:, None]
    fu = 2 * col + 1 - 256
    fv = 256 - (2 * row + 1)
    for c in range(3):
        num = C[c] * 256 + Cu[c] * fu + Cv[c] * fv  # Q20
        out[..., c] = np.clip((num * v + (1 << 19)) >> 20, 0, 255).astype(np.uint8)
    return out


def render_waveform(
    counts: np.ndarray, intensity: int, display: int, n_components: int, yuv_mode: bool
) -> np.ndarray:
    """counts (3,256,W) u8 ascending -> RGBA image (reference 5 techniques)."""
    order = DISP_YUV if yuv_mode else DISP_RGB
    vals = np.minimum(
        counts[list(order)][:, ::-1, :].astype(np.int64) * int(intensity), 255
    )  # (3, 256, W) display-ordered, row 0 = level 255
    n = n_components
    if n <= 1 or display == 0:  # Overlay
        rgb = np.moveaxis(vals, 0, -1).astype(np.uint8)
    else:
        bands = (0, 1, 2) if n == 3 else (0, 2)
        parts = []
        for b in bands:
            band = np.stack(
                [
                    np.clip((vals[b] * TINT_Q12[b, c] + 2048) >> 12, 0, 255)
                    for c in range(3)
                ],
                axis=-1,
            ).astype(np.uint8)
            parts.append(band)
        rgb = np.concatenate(parts, axis=0 if display == 1 else 1)
    out = np.empty(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = rgb
    out[..., 3] = 255
    return out


def render_histogram(
    levels: np.ndarray,
    hi_max: np.ndarray,
    level_height: int,
    display: int,
    n_components: int,
    yuv_mode: bool,
) -> np.ndarray:
    """levels (3,256) f32 + hi_max (3,) -> RGBA bars (reference fill test
    ``level >= (1-(row+0.5)/H)*hi_max`` at pixel centers, f32 single-mul)."""
    order = DISP_YUV if yuv_mode else DISP_RGB
    H = level_height
    lv = levels[list(order)].astype(np.float32)
    hm = hi_max[list(order)].astype(np.float32)
    thr = (
        np.float32(1.0)
        - (np.arange(H, dtype=np.float32) + np.float32(0.5)) / np.float32(H)
    )[:, None]
    fill = lv[:, None, :] >= thr[None] * hm[:, None, None]  # (3, H, 256)
    n = n_components
    if n <= 1 or display == 0:
        rgb = np.moveaxis(np.where(fill, 255, 0).astype(np.uint8), 0, -1)
    else:
        bands = (0, 1, 2) if n == 3 else (0, 2)
        parts = []
        for b in bands:
            band = np.where(fill[b][..., None], TINT_U8[b], np.uint8(0)).astype(
                np.uint8
            )
            parts.append(band)
        rgb = np.concatenate(parts, axis=0 if display == 1 else 1)
    out = np.empty(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = rgb
    out[..., 3] = 255
    return out
