"""NumPy golden model — the bit-exact oracle for every scope statistic.

Copied whole from ``obs_color_monitor_tpu/golden/reference.py`` so that
the torch port imports nothing of the JAX package;
``tests/test_torch_spec.py`` holds it equal to the original.

The reference has no unit tests of its accumulation loops (SURVEY.md §4);
this module is the missing specification.  Every function here is an exact,
order-independent restatement of a reference CPU loop or shader, written in
integer/fixed-point arithmetic so that the TPU kernels can be tested for
bit-identical results.

Conventions (see colorspace.py): frames are RGBA uint8 (H, W, 4) in R,G,B,A
order; YUV u8 images are (H, W, 3) in Y,U,V order; statistic channel order
is (R,G,B) in RGB mode and (Y,U,V) in YUV mode.  Value axes are ascending
(the reference stores rows flipped, row = 255-value, purely so the texture
draws top-down — reference src/vectorscope.c:231, src/waveform.c:249-255;
the flip lives in the renderer here).
"""

from __future__ import annotations

import numpy as np

from ..colorspace import (
    Colorspace,
    FIXED_COEFFS,
    FIXED_SHIFT,
    LUMA_COEF,
    quantize_unorm8,
)

VS_SIZE = 256  # reference src/vectorscope.c:21
WV_SIZE = 256  # reference src/waveform.c:20
HI_SIZE = 256  # reference src/histogram.c:21


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

def rgb_to_yuv_u8(rgba: np.ndarray, cs: Colorspace) -> np.ndarray:
    """Canonical quantized RGB->YUV (see colorspace.py docstring).

    Mirrors the reference conversion pass (data/common.effect:23-43 read
    back through a BGRA8 staging surface, src/common.c:170-221) under this
    framework's fixed-point quantization spec.  Alpha is ignored; the
    conversion output alpha is always 255 (the shader writes a=1).
    """
    rgba = np.asarray(rgba)
    assert rgba.dtype == np.uint8 and rgba.shape[-1] == 4
    k = FIXED_COEFFS[Colorspace(cs)].astype(np.int64)  # (3, 4)
    r = rgba[..., 0].astype(np.int64)
    g = rgba[..., 1].astype(np.int64)
    b = rgba[..., 2].astype(np.int64)
    half = 1 << (FIXED_SHIFT - 1)
    out = np.empty(rgba.shape[:-1] + (3,), dtype=np.uint8)
    for i in range(3):
        acc = k[i, 0] * r + k[i, 1] * g + k[i, 2] * b + k[i, 3] + half
        out[..., i] = np.clip(acc >> FIXED_SHIFT, 0, 255).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# Capture path: downscale + ROI crop
# ---------------------------------------------------------------------------

def downscale(rgba: np.ndarray, scale: int) -> np.ndarray:
    """Pre-downscale by integer factor with 2x2 bilinear taps.

    The reference draws the target into a (w/scale, h/scale) texrender
    (reference src/common.c:141-168,249-250); with a linear sampler that is
    a bilinear read at each output pixel center.  Canonical spec: sample the
    source at ``(x + 0.5) * scale - 0.5`` per axis, bilinear-interpolate the
    4 nearest texels in float32, quantize round-half-up per channel.
    scale=1 is the identity (bit-exact passthrough).
    """
    rgba = np.asarray(rgba)
    assert rgba.dtype == np.uint8
    scale = int(scale)
    if scale <= 1:
        return rgba
    h, w = rgba.shape[-3], rgba.shape[-2]
    oh, ow = h // scale, w // scale
    if oh == 0 or ow == 0:
        raise ValueError(f"frame {w}x{h} too small for scale {scale}")

    def axis_taps(n_out: int, n_in: int):
        pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(
            scale
        ) - np.float32(0.5)
        lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
        hi = np.clip(lo + 1, 0, n_in - 1)
        frac = (pos - lo.astype(np.float32)).astype(np.float32)
        return lo, hi, frac

    ylo, yhi, fy = axis_taps(oh, h)
    xlo, xhi, fx = axis_taps(ow, w)

    img = rgba.astype(np.float32)
    top = img[..., ylo, :, :]
    bot = img[..., yhi, :, :]
    row = top + (bot - top) * fy[:, None, None]
    left = row[..., :, xlo, :]
    right = row[..., :, xhi, :]
    out = left + (right - left) * fx[None, :, None]
    return quantize_unorm8(out / np.float32(255.0))


def roi_crop(rgba: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """ROI sub-rect in scaled coordinates (reference src/common.c:273-282)."""
    return rgba[..., y0:y1, x0:x1, :]


# ---------------------------------------------------------------------------
# Statistics accumulators
# ---------------------------------------------------------------------------

def vectorscope_counts(yuv: np.ndarray) -> np.ndarray:
    """256x256 CbCr occupancy with u8 saturation.

    Exact port of the reference hot loop (src/vectorscope.c:217-238):
    every pixel increments ``dbuf[u + 256*(255-v)]`` saturating at 255; no
    alpha skip.  Saturating increment commutes with counting, so this
    computes full counts then clamps.  Returned layout is ``counts[v, u]``
    with v ascending (the reference's 255-v row flip happens at render).
    """
    yuv = np.asarray(yuv)
    assert yuv.dtype == np.uint8 and yuv.shape[-1] == 3
    u = yuv[..., 1].reshape(-1).astype(np.int64)
    v = yuv[..., 2].reshape(-1).astype(np.int64)
    counts = np.bincount(v * VS_SIZE + u, minlength=VS_SIZE * VS_SIZE)
    return np.minimum(counts.reshape(VS_SIZE, VS_SIZE), 255).astype(np.uint8)


def _select_planes(
    rgba: np.ndarray, yuv: np.ndarray | None, components
) -> tuple[np.ndarray, np.ndarray]:
    """(data(H,W,3), alpha(H,W)) for the component mode.

    RGB mode reads the RGB planes with the frame's alpha; YUV mode reads the
    converted planes — whose alpha is always 255, so the reference's alpha
    skip never fires there (the YUV conversion shader writes a=1,
    reference data/common.effect:30,41).
    """
    from ..config import Components

    components = Components(components)
    if components.is_yuv:
        assert yuv is not None
        alpha = np.full(yuv.shape[:-1], 255, dtype=np.uint8)
        return yuv, alpha
    return rgba[..., :3], rgba[..., 3]


def waveform_counts(rgba: np.ndarray, yuv: np.ndarray | None, components) -> np.ndarray:
    """Per-column 256-level intensity counts, u8 saturating.

    Exact port of src/waveform.c:220-257: for each enabled channel c and
    column x, count pixels with value v — skipping pixels whose alpha is 0.
    Output ``(3, 256, W)`` u8 with value ascending; disabled channels are
    zero (the reference zeroes the whole buffer first, src/waveform.c:226).
    Channel order: (R,G,B) or (Y,U,V) per Components.channel_select().
    """
    from ..config import Components

    components = Components(components)
    data, alpha = _select_planes(np.asarray(rgba), yuv, components)
    h, w = data.shape[0], data.shape[1]
    sel = components.channel_select()
    keep = alpha != 0
    out = np.zeros((3, WV_SIZE, w), dtype=np.uint8)
    xs = np.broadcast_to(np.arange(w, dtype=np.int64), (h, w))[keep]
    for c in range(3):
        if not sel[c]:
            continue
        vals = data[..., c].astype(np.int64)[keep]
        counts = np.bincount(vals * w + xs, minlength=WV_SIZE * w)
        out[c] = np.minimum(counts.reshape(WV_SIZE, w), 255).astype(np.uint8)
    return out


def histogram_counts(rgba: np.ndarray, yuv: np.ndarray | None, components) -> np.ndarray:
    """256-bin per-channel counts, u32 (no saturation).

    Exact port of src/histogram.c:357-395: per enabled channel, count
    pixels per value, skipping alpha==0 pixels.  Output ``(3, 256)`` u32,
    disabled channels zero.
    """
    from ..config import Components

    components = Components(components)
    data, alpha = _select_planes(np.asarray(rgba), yuv, components)
    sel = components.channel_select()
    keep = alpha != 0
    out = np.zeros((3, HI_SIZE), dtype=np.uint32)
    for c in range(3):
        if not sel[c]:
            continue
        vals = data[..., c].astype(np.int64)[keep]
        out[c] = np.bincount(vals, minlength=HI_SIZE).astype(np.uint32)
    return out


def histogram_hi_max(
    counts: np.ndarray,
    components,
    width: int,
    height: int,
    level_fixed: int,
    level_ratio_permille: int,
) -> np.ndarray:
    """Per-channel normalization ceiling (reference src/histogram.c:357-418).

    Priority: fixed pixel level > ratio (percent*10, threshold
    ``width*height*ratio/1000``, reference src/histogram.c:397-402) > auto
    per-channel max.  Every path floors at 1.
    """
    from ..config import Components

    components = Components(components)
    sel = components.channel_select()
    if level_fixed > 0:
        v = max(1, int(level_fixed))
        return np.array([v, v, v], dtype=np.uint32)
    if level_ratio_permille > 0:
        v = max(1, (int(width) * int(height) * int(level_ratio_permille)) // 1000)
        return np.array([v, v, v], dtype=np.uint32)
    hi = np.ones(3, dtype=np.uint32)
    for c in range(3):
        if sel[c]:
            hi[c] = max(1, int(counts[c].max()))
    return hi


def histogram_levels(
    counts: np.ndarray, hi_max: np.ndarray, components, logscale: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Float levels uploaded to the draw shader + effective hi_max.

    Log scale: ``log(count+1) / log(hi_max+1)`` with zeros staying zero and
    hi_max collapsing to 1 (reference src/histogram.c:405-413); otherwise
    the raw counts as float32 (reference src/histogram.c:414-417).
    Returns (levels (3,256) f32, hi_max_eff (3,) f32).
    """
    from ..config import Components

    components = Components(components)
    sel = components.channel_select()
    levels = np.zeros((3, HI_SIZE), dtype=np.float32)
    hi_eff = hi_max.astype(np.float32).copy()
    if logscale:
        for c in range(3):
            if not sel[c]:
                continue
            s = np.float32(1.0) / np.log(np.float32(hi_max[c] + 1))
            cc = counts[c].astype(np.float32)
            levels[c] = np.where(counts[c] > 0, np.log(cc + np.float32(1.0)) * s, 0.0)
            hi_eff[c] = 1.0
    else:
        levels = counts.astype(np.float32)
    return levels, hi_eff


# ---------------------------------------------------------------------------
# Overlay scopes (pure per-pixel shaders in the reference)
# ---------------------------------------------------------------------------

def _luma_fixed(rgba: np.ndarray, cs: Colorspace) -> np.ndarray:
    """Quantized-exact luma in 12-bit fixed point, as int64 'luma*2^12*255'.

    The overlay shaders compute ``y = dot(rgb, coef)`` on normalized floats
    (data/zebra.effect:29, data/falsecolor.effect:33) and compare against
    thresholds.  Canonical spec: fixed-point ``K_r*r + K_g*g + K_b*b``
    (u8 inputs), compared against ``round(th * 255 * 2^12)``.
    """
    cs = Colorspace(cs)
    kr, kg, kb = LUMA_COEF[cs]
    scale = 1 << FIXED_SHIFT
    K = [int(round(c * scale)) for c in (kr, kg, kb)]
    r = rgba[..., 0].astype(np.int64)
    g = rgba[..., 1].astype(np.int64)
    b = rgba[..., 2].astype(np.int64)
    return K[0] * r + K[1] * g + K[2] * b


def luma_threshold_fixed(th: float) -> int:
    """Threshold in the same fixed-point scale as :func:`_luma_fixed`."""
    return int(round(th * 255.0 * (1 << FIXED_SHIFT)))


def zebra(
    rgba: np.ndarray, th_low: float, th_high: float, tm: float, cs: Colorspace
) -> np.ndarray:
    """Diagonal-stripe overlay (exact port of data/zebra.effect:26-48).

    Pixels with th_low <= luma <= th_high show black stripes where
    ``int(px + py + tm) mod 6 < 3``; the shader's pixel position is the
    pixel center, so with integer indices the phase is
    ``floor(x + y + 1 + tm)`` (reference zebra.effect:31).  ``tm`` is the
    stripe clock advanced 4.0/s mod 12 (reference src/zebra.c:660-666).
    """
    rgba = np.asarray(rgba)
    luma = _luma_fixed(rgba, cs)
    lo = luma_threshold_fixed(th_low)
    hi = luma_threshold_fixed(th_high)
    # Phase in float32 — the exact arithmetic the device kernel performs
    # (x+y+1 is integer-exact in f32 for any sane frame size; adding the
    # f32 stripe clock is then the identical rounding on both paths).
    h, w = rgba.shape[-3], rgba.shape[-2]
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    phase = np.floor(xx + yy + np.float32(1.0) + np.float32(tm)).astype(np.int64) % 6
    stripe = (luma >= lo) & (luma <= hi) & (phase < 3)
    out = rgba.copy()
    out[stripe] = np.array([0, 0, 0, 255], dtype=np.uint8)
    return out


# 12-band cascade (reference data/falsecolor.effect:38-61); upper bounds are
# exclusive, thresholds on normalized luma.  (band_upper, RGBA float color)
FALSECOLOR_BANDS = [
    (0.02, (0.85, 0.22, 1.0, 1.0)),  # bright purple
    (0.10, (0.0, 0.0, 1.0, 1.0)),  # blue
    (0.20, (0.33, 0.55, 1.0, 1.0)),  # light blue
    (0.42, (0.3, 0.3, 0.3, 1.0)),  # dark grey
    (0.48, (0.6, 1.0, 0.0, 1.0)),  # green
    (0.52, (0.5, 0.5, 0.5, 1.0)),  # medium grey
    (0.58, (0.95, 0.62, 0.62, 1.0)),  # pink
    (0.78, (0.7, 0.7, 0.7, 1.0)),  # light grey
    (0.84, (0.7, 0.7, 0.0, 1.0)),  # dark yellow
    (0.94, (1.0, 1.0, 0.0, 1.0)),  # yellow
    (1.00, (0.9, 0.5, 0.0, 1.0)),  # orange
    (None, (0.9, 0.2, 0.0, 1.0)),  # red (y >= 1.0)
]


def falsecolor_band_colors_u8() -> np.ndarray:
    """The 12 band colors as RGBA u8 (quantized round-half-up)."""
    return np.stack(
        [quantize_unorm8(np.asarray(c, dtype=np.float32)) for _, c in FALSECOLOR_BANDS]
    )


def falsecolor_band_index(rgba: np.ndarray, cs: Colorspace) -> np.ndarray:
    """Band index 0..11 per pixel from quantized-exact luma."""
    luma = _luma_fixed(np.asarray(rgba), cs)
    idx = np.full(luma.shape, len(FALSECOLOR_BANDS) - 1, dtype=np.int32)
    for i in range(len(FALSECOLOR_BANDS) - 2, -1, -1):
        th = luma_threshold_fixed(FALSECOLOR_BANDS[i][0])
        idx = np.where(luma < th, i, idx)
    return idx


def falsecolor(
    rgba: np.ndarray, cs: Colorspace, lut: np.ndarray | None = None
) -> np.ndarray:
    """False-color mapping (exact port of data/falsecolor.effect:31-61).

    Without a LUT: the hardcoded 12-band cascade.  With a LUT of shape
    (N, 4): point-sample at ``u = luma`` with clamp —
    ``i = clip(floor(luma * N), 0, N-1)`` (reference falsecolor.effect:36,
    lut_sampler is Point/Clamp).  LUT indexing uses float luma (the index
    granularity is coarse, so fixed/float agree except exactly on texel
    boundaries; canonical spec uses the fixed-point luma).
    """
    rgba = np.asarray(rgba)
    if lut is not None:
        lut = np.asarray(lut, dtype=np.uint8)
        n = lut.shape[0]
        luma = _luma_fixed(rgba, cs)  # luma * 255 * 2^12
        scale = 255 << FIXED_SHIFT
        i = np.clip((luma * n) // scale, 0, n - 1)
        return lut[i]
    colors = falsecolor_band_colors_u8()
    return colors[falsecolor_band_index(rgba, cs)]


def focus_peaking(
    rgba: np.ndarray, threshold: float, peaking_rgba: tuple[float, float, float, float]
) -> np.ndarray:
    """Edge highlight (exact port of data/focuspeaking.effect:26-48).

    4-neighbor cross: d = mean over RGB of mean over +-dx,+-dy of
    |neighbor - center| (edge-clamped), scaled 0.25 then 1/3; pixels with
    d >= threshold are replaced by the peaking color.  Canonical spec
    computes d in fixed point: with u8 values, the shader's
    ``d = sum_c sum_n |n - c| * 0.25 * 0.3333 / 255`` is compared to the
    threshold; we compare ``sum_c sum_n |n-c|`` (an exact integer in
    [0, 12*255]) against ``threshold * 255 * 12 / (0.25*4*0.3333*3)`` — i.e.
    ``threshold / (0.25 * 0.3333) * 255`` = threshold * 12.0012 * 255 —
    keeping the shader's literal 0.3333 constant.
    """
    rgba = np.asarray(rgba)
    rgb = rgba[..., :3].astype(np.int64)

    def shift(a, dy, dx):
        # edge clamp (sampler AddressU/V = Clamp)
        h, w = a.shape[0], a.shape[1]
        ys = np.clip(np.arange(h) + dy, 0, h - 1)
        xs = np.clip(np.arange(w) + dx, 0, w - 1)
        return a[ys][:, xs]

    acc = np.zeros(rgb.shape[:2], dtype=np.int64)
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        acc += np.abs(shift(rgb, dy, dx) - rgb).sum(axis=-1)
    peak = acc >= peaking_threshold_fixed(threshold)
    color = quantize_unorm8(np.asarray(peaking_rgba, dtype=np.float32))
    out = rgba.copy()
    out[peak] = color
    return out


def peaking_threshold_fixed(threshold: float) -> int:
    """Integer peaking threshold shared by golden model and device kernels.

    d = acc/255 * 0.25 * 0.3333; peak where d >= threshold, i.e.
    ``acc >= threshold * 255 / (0.25 * 0.3333)`` — computed once on host in
    float64 so both paths compare against the identical integer.
    """
    return int(np.ceil(float(threshold) * 255.0 / (0.25 * 0.3333)))


def zebra_tm_advance(tm: float, seconds: float) -> float:
    """Stripe clock: +4.0/s, wrap above 12 (reference src/zebra.c:660-666)."""
    tm += seconds * 4.0
    if tm > 12.0:
        tm -= 12.0
    return tm
