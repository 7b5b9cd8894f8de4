"""The scope pipeline's plain reference in PyTorch: NV12 decode, the
scaled capture, the three statistics, the three overlays and the three
renders, each the canonical integer or float32 rule that
``doc/bit-exactness.md`` states, written from that spec and the reference
plugin's shaders.  It imports nothing of the program.

Frames are (H, W, 4) u8 RGBA tensors; statistics are int64.  ``ds_dtype``
is the float type of the capture's bilinear taps: float32 by the spec; the
correctness control passes a lower precision.
"""

from __future__ import annotations

import math

import torch

FIXED_SHIFT = 12
HALF = 1 << (FIXED_SHIFT - 1)

# published luma coefficients (Kr, Kb) of ITU-R BT.601 and BT.709
_KRB = {1: (0.299, 0.114), 2: (0.2126, 0.0722)}

# the reference shader's full-range RGB->YUV rows (r, g, b, offset), with the
# -1/256 bias on U (data/common.effect:23-43)
YUV_COEF = {
    1: ((0.299, 0.587, 0.114, 0.0), (-0.147643, -0.289855, 0.4375, 0.5 - 1 / 256),
        (0.4375, -0.366351, -0.071147, 0.5)),
    2: ((0.2126, 0.7152, 0.0722, 0.0), (-0.100643, -0.338571, 0.439216, 0.5 - 1 / 256),
        (0.439216, -0.398941, -0.040273, 0.5)),
}
# the vectorscope draw tint (src/vectorscope.c:418-439): base, per-u, per-v
VS_TINT = {
    1: ((0.5, 0.5, 0.5), (0.0, -0.3441, 1.772), (1.402, -0.7141, 0.0)),
    2: ((0.5, 0.5, 0.5), (0.0, -0.1873, 1.8556), (1.5748, -0.4681, 0.0)),
}
# the false-colour cascade (data/falsecolor.effect:38-61): exclusive upper
# bounds on normalised luma, RGBA colours
FALSECOLOR_BANDS = [
    (0.02, (0.85, 0.22, 1.0, 1.0)), (0.10, (0.0, 0.0, 1.0, 1.0)),
    (0.20, (0.33, 0.55, 1.0, 1.0)), (0.42, (0.3, 0.3, 0.3, 1.0)),
    (0.48, (0.6, 1.0, 0.0, 1.0)), (0.52, (0.5, 0.5, 0.5, 1.0)),
    (0.58, (0.95, 0.62, 0.62, 1.0)), (0.78, (0.7, 0.7, 0.7, 1.0)),
    (0.84, (0.7, 0.7, 0.0, 1.0)), (0.94, (1.0, 1.0, 0.0, 1.0)),
    (1.00, (0.9, 0.5, 0.0, 1.0)), (None, (0.9, 0.2, 0.0, 1.0)),
]


def unorm8(x: float) -> int:
    """Round-half-up float -> u8 of one value in [0, 1] (float32 math)."""
    x32 = torch.tensor(min(max(x, 0.0), 1.0), dtype=torch.float32)
    return int(torch.floor(x32 * 255.0 + 0.5))


def nv12_coefficients(cs: int) -> tuple[int, int, int, int, int]:
    """(K_Y, K_R.Cr, K_G.Cb, K_G.Cr, K_B.Cb) of the limited-range inverse
    matrix in 12-bit fixed point, derived from the published Kr, Kb: luma
    scaled by 255/219, chroma by 255/224."""
    kr, kb = _KRB[cs]
    kg = 1.0 - kr - kb
    sy, sc = 255.0 / 219.0 * 4096, 255.0 / 224.0 * 4096
    return (round(sy), round(2 * (1 - kr) * sc), round(-2 * kb * (1 - kb) / kg * sc),
            round(-2 * kr * (1 - kr) / kg * sc), round(2 * (1 - kb) * sc))


def nv12_to_rgba(y: torch.Tensor, uv: torch.Tensor, cs: int) -> torch.Tensor:
    """NV12 (y (H, W) u8, uv (H/2, W) interleaved CbCr) -> (H, W, 4) u8:
    ``clip((K_Y (Y-16) + K.C + 2048) >> 12)``, chroma sample (row // 2,
    col & ~1) serving the pixel at (row, col), alpha 255."""
    k_y, k_rcr, k_gcb, k_gcr, k_bcb = nv12_coefficients(cs)
    yp = (y.to(torch.int64) - 16) * k_y
    c = uv.to(torch.int64) - 128
    cb = c[:, 0::2].repeat_interleave(2, 0).repeat_interleave(2, 1)
    cr = c[:, 1::2].repeat_interleave(2, 0).repeat_interleave(2, 1)

    def q(acc):
        return torch.div(acc + HALF, 1 << FIXED_SHIFT, rounding_mode="floor").clamp(0, 255)

    out = torch.empty(y.shape + (4,), dtype=torch.uint8, device=y.device)
    out[..., 0] = q(yp + k_rcr * cr)
    out[..., 1] = q(yp + k_gcb * cb + k_gcr * cr)
    out[..., 2] = q(yp + k_bcb * cb)
    out[..., 3] = 255
    return out


def _full(like: torch.Tensor, v: float) -> torch.Tensor:
    """A divisor as a tensor: divided by a host scalar, CUDA multiplies by
    its rounded reciprocal, which is not the IEEE quotient the spec takes."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def downscale(rgba: torch.Tensor, scale: int, ds_dtype=torch.float32) -> torch.Tensor:
    """Integer-factor pre-downscale: sample at ``(x + 0.5) * scale - 0.5``
    per axis, bilinear over the 4 nearest texels in ``ds_dtype``, quantise
    ``floor(clip(v / 255) * 255 + 0.5)`` (src/common.c:141-168)."""
    if scale <= 1:
        return rgba
    h, w = rgba.shape[0], rgba.shape[1]
    dev = rgba.device

    def taps(n_out, n_in):
        # the positions in float32 whatever ds_dtype: exact for every frame size
        pos = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * scale - 0.5
        lo = torch.floor(pos).to(torch.int64).clamp(0, n_in - 1)
        hi = (lo + 1).clamp(0, n_in - 1)
        return lo, hi, (pos - lo.to(torch.float32)).to(ds_dtype)

    ylo, yhi, fy = taps(h // scale, h)
    xlo, xhi, fx = taps(w // scale, w)
    img = rgba.to(ds_dtype)
    top, bot = img[ylo], img[yhi]
    row = top + (bot - top) * fy[:, None, None]
    left, right = row[:, xlo], row[:, xhi]
    out = left + (right - left) * fx[None, :, None]
    x = (out / _full(out, 255.0)).clamp(0.0, 1.0)
    return torch.floor(x * 255.0 + 0.5).to(torch.uint8)


def to_yuv(rgba: torch.Tensor, cs: int) -> torch.Tensor:
    """(H, W, 3) u8 Y, U, V: ``clip((K_r r + K_g g + K_b b + O + 2048) >> 12)``
    with ``K = round(coef * 4096)``, ``O = round(offset * 255 * 4096)``."""
    rgb = rgba[..., :3].to(torch.int64)
    out = torch.empty(rgba.shape[:2] + (3,), dtype=torch.uint8, device=rgba.device)
    for i, (cr, cg, cb, off) in enumerate(YUV_COEF[cs]):
        k = [round(c * 4096) for c in (cr, cg, cb)] + [round(off * 255 * 4096)]
        acc = k[0] * rgb[..., 0] + k[1] * rgb[..., 1] + k[2] * rgb[..., 2] + k[3] + HALF
        out[..., i] = torch.div(acc, 4096, rounding_mode="floor").clamp(0, 255)
    return out


def vectorscope_counts(yuv: torch.Tensor) -> torch.Tensor:
    """(256, 256) [v, u] pixel counts saturating at 255 (src/vectorscope.c:217-238)."""
    idx = yuv[..., 2].to(torch.int64) * 256 + yuv[..., 1].to(torch.int64)
    return torch.bincount(idx.reshape(-1), minlength=65536).reshape(256, 256).clamp(max=255)


def waveform_counts(rgba: torch.Tensor) -> torch.Tensor:
    """(3, 256, W) per-column R, G, B level counts saturating at 255,
    alpha-0 pixels skipped (src/waveform.c:220-257)."""
    h, w = rgba.shape[0], rgba.shape[1]
    keep = (rgba[..., 3] != 0).reshape(-1)
    xs = torch.arange(w, device=rgba.device).expand(h, w).reshape(-1)[keep]
    out = []
    for c in range(3):
        v = rgba[..., c].to(torch.int64).reshape(-1)[keep]
        out.append(torch.bincount(v * w + xs, minlength=256 * w).reshape(256, w))
    return torch.stack(out).clamp(max=255)


def histogram_counts(rgba: torch.Tensor) -> torch.Tensor:
    """(3, 256) R, G, B level counts, alpha-0 pixels skipped (src/histogram.c:357-395)."""
    keep = (rgba[..., 3] != 0).reshape(-1)
    return torch.stack([torch.bincount(rgba[..., c].to(torch.int64).reshape(-1)[keep],
                                       minlength=256) for c in range(3)])


def luma_fixed(rgba: torch.Tensor, cs: int) -> torch.Tensor:
    """Luma * 255 * 2^12 as an exact integer: ``K_r r + K_g g + K_b b``."""
    kr, kb = _KRB[cs]
    k = [round(c * 4096) for c in (kr, 1.0 - kr - kb, kb)]
    rgb = rgba[..., :3].to(torch.int64)
    return k[0] * rgb[..., 0] + k[1] * rgb[..., 1] + k[2] * rgb[..., 2]


def _threshold(th: float) -> int:
    return int(round(th * 255.0 * 4096))


def zebra(rgba: torch.Tensor, th_low: float, th_high: float, tm: float, cs: int) -> torch.Tensor:
    """Black stripes where th_low <= luma <= th_high and
    ``floor(x + y + 1 + tm) mod 6 < 3`` in float32 (data/zebra.effect:26-48)."""
    h, w = rgba.shape[0], rgba.shape[1]
    luma = luma_fixed(rgba, cs)
    yy = torch.arange(h, dtype=torch.float32, device=rgba.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=rgba.device)[None, :]
    t32 = torch.tensor(tm, dtype=torch.float32, device=rgba.device)
    phase = torch.remainder(torch.floor(xx + yy + 1.0 + t32).to(torch.int64), 6)
    stripe = (luma >= _threshold(th_low)) & (luma <= _threshold(th_high)) & (phase < 3)
    out = rgba.clone()
    out[stripe] = torch.tensor([0, 0, 0, 255], dtype=torch.uint8, device=rgba.device)
    return out


def falsecolor(rgba: torch.Tensor, cs: int) -> torch.Tensor:
    """The 12-band cascade on the fixed-point luma."""
    luma = luma_fixed(rgba, cs)
    idx = torch.full(luma.shape, len(FALSECOLOR_BANDS) - 1, dtype=torch.int64,
                     device=rgba.device)
    for i in range(len(FALSECOLOR_BANDS) - 2, -1, -1):
        idx = torch.where(luma < _threshold(FALSECOLOR_BANDS[i][0]), i, idx)
    colors = torch.tensor([[unorm8(c) for c in col] for _, col in FALSECOLOR_BANDS],
                          dtype=torch.uint8, device=rgba.device)
    return colors[idx]


def peaking_threshold(threshold: float) -> int:
    """The shader's ``d >= threshold`` with ``d = acc / 255 * 0.25 * 0.3333``
    as an integer bound on ``acc``, in float64 (data/focuspeaking.effect:26-48)."""
    return int(math.ceil(float(threshold) * 255.0 / (0.25 * 0.3333)))


def focus_peaking(rgba: torch.Tensor, threshold: float, color: tuple) -> torch.Tensor:
    """Pixels whose 4-neighbour sum of |neighbour - centre| over R, G, B
    (edges clamped) reaches the threshold take the peaking colour."""
    rgb = rgba[..., :3].to(torch.int64)
    h, w = rgb.shape[0], rgb.shape[1]
    dev = rgba.device
    rows, cols = torch.arange(h, device=dev), torch.arange(w, device=dev)
    acc = torch.zeros((h, w), dtype=torch.int64, device=dev)
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        n = rgb[(rows + dy).clamp(0, h - 1)][:, (cols + dx).clamp(0, w - 1)]
        acc += (n - rgb).abs().sum(-1)
    out = rgba.clone()
    out[acc >= peaking_threshold(threshold)] = torch.tensor(color, dtype=torch.uint8, device=dev)
    return out


def zebra_tm_advance(tm: float, seconds: float) -> float:
    """The stripe clock: +4.0/s, wrapping above 12 (src/zebra.c:660-666)."""
    tm += seconds * 4.0
    if tm > 12.0:
        tm -= 12.0
    return tm


def render_vectorscope(counts: torch.Tensor, intensity: int, cs: int) -> torch.Tensor:
    """UV-tinted draw: ``v = min(count * intensity, 255)`` (rows flipped, v
    up), channel ``(C*256 + Cu*(2u+1-256) + Cv*(256-(2r+1))) * v`` over 2^20,
    round half up, clamp."""
    dev = counts.device
    v = (counts.flip(0).to(torch.int64) * intensity).clamp(max=255)
    base, tu, tv = VS_TINT[cs]
    col = torch.arange(256, device=dev)[None, :]
    row = torch.arange(256, device=dev)[:, None]
    fu, fv = 2 * col + 1 - 256, 256 - (2 * row + 1)
    out = torch.full((256, 256, 4), 255, dtype=torch.uint8, device=dev)
    for c in range(3):
        num = round(base[c] * 4096) * 256 + round(tu[c] * 4096) * fu + round(tv[c] * 4096) * fv
        out[..., c] = torch.div(num * v + (1 << 19), 1 << 20, rounding_mode="floor").clamp(0, 255)
    return out


def render_waveform(counts: torch.Tensor, intensity: int) -> torch.Tensor:
    """Overlay display of (3, 256, W) R, G, B counts: row 0 is level 255,
    ``min(count * intensity, 255)`` per channel."""
    vals = (counts.flip(1).to(torch.int64) * intensity).clamp(max=255)
    out = torch.full(vals.shape[1:] + (4,), 255, dtype=torch.uint8, device=counts.device)
    out[..., :3] = vals.permute(1, 2, 0)
    return out


def render_histogram(counts: torch.Tensor, level_height: int) -> torch.Tensor:
    """Overlay display in AUTO level mode: ``hi_max`` the channel's largest
    count (at least 1), a bar where ``count >= (1 - (row + 0.5) / H) * hi_max``
    in single float32 multiplies."""
    dev = counts.device
    levels = counts.to(torch.float32)
    hi = counts.max(dim=1).values.clamp(min=1).to(torch.float32)
    rows = torch.arange(level_height, dtype=torch.float32, device=dev)
    thr = (1.0 - (rows + 0.5) / _full(rows, float(level_height)))[:, None]
    fill = levels[:, None, :] >= thr[None] * hi[:, None, None]
    out = torch.full((level_height, 256, 4), 255, dtype=torch.uint8, device=dev)
    out[..., :3] = torch.where(fill, 255, 0).permute(1, 2, 0).to(torch.uint8)
    return out


def blend(image: torch.Tensor, overlay: torch.Tensor | None) -> torch.Tensor:
    """``(s a + d (255 - a) + 127) // 255`` of an RGBA overlay over an
    image whose alpha passes through."""
    if overlay is None:
        return image
    a = overlay[..., 3:4].to(torch.int64)
    rgb = (overlay[..., :3].to(torch.int64) * a + image[..., :3].to(torch.int64) * (255 - a)
           + 127) // 255
    return torch.cat([rgb.to(torch.uint8), image[..., 3:]], dim=-1)
