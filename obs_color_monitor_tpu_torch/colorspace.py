"""Colorspace definitions and the canonical RGB->YUV quantization spec.

Copied whole from ``obs_color_monitor_tpu/colorspace.py`` so that the
torch port imports nothing of the JAX package; ``tests/test_torch_spec.py``
holds every constant here equal to the original.

The reference converts RGB->YUV in a GPU pixel shader with float32
coefficients and writes the result through an 8-bit UNORM surface
(reference data/common.effect:23-43); the CPU accumulators then read those
quantized bytes back (reference src/common.c:335-373).  GPU float->UNORM8
rounding is vendor-defined, so the reference itself has no bit-exact spec.

This framework *defines* the canonical conversion in 12-bit fixed point so
the golden model (NumPy) and the TPU kernels agree bit-for-bit:

    q(c) = clip((K_r*r + K_g*g + K_b*b + O + 2^11) >> 12, 0, 255)

with ``K_x = round(coef * 2^12)`` and ``O = round(offset * 255 * 2^12)``,
where ``coef``/``offset`` are the reference shader constants, including the
odd ``-1/256`` bias on U (reference data/common.effect:27,38).  The result
matches the reference's float path within +-1 LSB (differing only on exact
rounding boundaries) and is deterministic on every backend.

The 2^12 scale is chosen so every intermediate is an integer-valued float32
(products <= 255 * 2^12 < 2^21 << 2^24): the TPU kernels can run the whole
conversion on the fast f32 VPU path (int32 multiplies are emulated and
slow) while staying bit-identical to the golden model's int64 arithmetic.

Channel conventions (this framework): frames are RGBA uint8 ``(..., H, W, 4)``
in R,G,B,A order; YUV images are ``(..., H, W, 3)`` in Y,U,V order.  (The
reference's BGRA-readback byte order — U at byte 0, Y at byte 1, V at byte 2,
reference src/vectorscope.c:217-238 — is a staging-surface artifact and is
not reproduced.)
"""

from __future__ import annotations

import enum

import numpy as np


class Colorspace(enum.IntEnum):
    """Mirrors the reference property values (reference src/util.c:15-23)."""

    AUTO = 0
    BT601 = 1
    BT709 = 2


# Video-info default used to resolve AUTO; the reference asks OBS for the
# active video colorspace and falls back to 709 (reference src/util.c:25-41).
_default_video_colorspace = Colorspace.BT709


def set_default_video_colorspace(cs: Colorspace) -> None:
    """Set the process-wide colorspace that AUTO resolves to.

    Stands in for the reference's ``obs_get_video_info`` query
    (reference src/util.c:29-40).
    """
    global _default_video_colorspace
    cs = Colorspace(cs)
    if cs == Colorspace.AUTO:
        raise ValueError("default video colorspace must be BT601 or BT709")
    _default_video_colorspace = cs


def calc_colorspace(cs: int | Colorspace) -> Colorspace:
    """Resolve AUTO to a concrete colorspace (reference src/util.c:25-41)."""
    cs = int(cs)
    if cs in (int(Colorspace.BT601), int(Colorspace.BT709)):
        return Colorspace(cs)
    return _default_video_colorspace


# ---------------------------------------------------------------------------
# Shader coefficients (reference data/common.effect:23-43).  Full-range
# matrices; U carries the -1/256 bias the reference shader applies.
# Rows: (r, g, b) coefficients; offsets in normalized [0,1] units.
# ---------------------------------------------------------------------------

YUV_COEF = {
    Colorspace.BT601: {
        "y": (0.299000, 0.587000, 0.114000, 0.0),
        "u": (-0.147643, -0.289855, 0.437500, 0.5 - 1.0 / 256.0),
        "v": (0.437500, -0.366351, -0.071147, 0.5),
    },
    Colorspace.BT709: {
        "y": (0.212600, 0.715200, 0.072200, 0.0),
        "u": (-0.100643, -0.338571, 0.439216, 0.5 - 1.0 / 256.0),
        "v": (0.439216, -0.398941, -0.040273, 0.5),
    },
}

# Display-side chroma tint bases used by the vectorscope draw shader
# (reference src/vectorscope.c:418-439): color + color_u*(2u-1) + color_v*(1-2v).
VECTORSCOPE_TINT = {
    Colorspace.BT601: {
        "color": (0.5, 0.5, 0.5, 1.0),
        "color_u": (0.0, -0.3441, 1.772),
        "color_v": (1.402, -0.7141, 0.0),
    },
    Colorspace.BT709: {
        "color": (0.5, 0.5, 0.5, 1.0),
        "color_u": (0.0, -0.1873, 1.8556),
        "color_v": (1.5748, -0.4681, 0.0),
    },
}

# Luma coefficients used by zebra / false color overlays
# (reference data/zebra.effect:29,41, data/falsecolor.effect:33,70).
LUMA_COEF = {
    Colorspace.BT601: (0.299000, 0.587000, 0.114000),
    Colorspace.BT709: (0.212600, 0.715200, 0.072200),
}

# Integer RGB->UV macros used for the skin-tone graticule line
# (reference src/vectorscope.c:28-34); /1024 is C truncating division.
def rgb2uv_int(r: int, g: int, b: int, cs: Colorspace) -> tuple[int, int]:
    if cs == Colorspace.BT601:
        u = int((-150 * r - 296 * g + 448 * b) / 1024) + 128
        v = int((448 * r - 374 * g - 72 * b) / 1024) + 128
    else:
        u = int((-102 * r - 346 * g + 450 * b) / 1024) + 128
        v = int((450 * r - 408 * g - 40 * b) / 1024) + 128
    return u, v


FIXED_SHIFT = 12
_FIXED_SCALE = 1 << FIXED_SHIFT


def fixed_point_coeffs(cs: Colorspace) -> np.ndarray:
    """Integer coefficient matrix for the canonical conversion.

    Returns int32 ``(3, 4)``: rows Y,U,V; columns K_r, K_g, K_b, O where
    ``q = (K_r*r + K_g*g + K_b*b + O + 2^11) >> 12`` for u8 r,g,b.
    """
    c = YUV_COEF[Colorspace(cs)]
    rows = []
    for ch in ("y", "u", "v"):
        cr, cg, cb, off = c[ch]
        rows.append(
            [
                int(round(cr * _FIXED_SCALE)),
                int(round(cg * _FIXED_SCALE)),
                int(round(cb * _FIXED_SCALE)),
                int(round(off * 255.0 * _FIXED_SCALE)),
            ]
        )
    return np.asarray(rows, dtype=np.int32)


# Precomputed for both colorspaces; consumed by golden model and kernels.
FIXED_COEFFS = {
    Colorspace.BT601: fixed_point_coeffs(Colorspace.BT601),
    Colorspace.BT709: fixed_point_coeffs(Colorspace.BT709),
}


def quantize_unorm8(x: np.ndarray) -> np.ndarray:
    """Canonical float->u8 UNORM quantization: round-half-up.

    Defined as ``floor(clip(x,0,1)*255 + 0.5)``; used anywhere this framework
    quantizes float pixel values (downscale, LUT sampling positions are NOT
    quantized — only stored u8 images are).
    """
    x = np.clip(np.asarray(x, dtype=np.float32), 0.0, 1.0)
    return np.floor(x * np.float32(255.0) + np.float32(0.5)).astype(np.uint8)
