"""Tiny host-side rasterizer for graticule / legend overlays.

Copied whole from ``obs_color_monitor_tpu/utils/draw.py`` so that the
torch port's graticules (``ops/graticule.py``) import nothing of the JAX
package.

The reference draws graticules with GPU line vertex buffers and PNG label
atlases (reference src/vectorscope.c:267-380, src/waveform.c:291-332,
src/histogram.c:452-520, src/zebra.c:385-597).  Here every graticule is
precomputed ONCE on the host into an RGBA uint8 overlay array (they only
change when settings change), then alpha-blended over the scope image on
device.  Labels use a built-in 5x7 bitmap font instead of the PNG atlas.

Canonical alpha blend (integer, round-half-up):
    out = (src*a + dst*(255-a) + 127) // 255
matching the reference's srcalpha/invsrcalpha GPU blend within 1 LSB.
"""

from __future__ import annotations

import numpy as np

# 5x7 bitmap font for graticule labels (subset used by the scopes).
_FONT = {
    "R": ["1110", "1001", "1001", "1110", "1010", "1001", "1001"],
    "G": ["0110", "1001", "1000", "1011", "1001", "1001", "0110"],
    "B": ["1110", "1001", "1001", "1110", "1001", "1001", "1110"],
    "C": ["0110", "1001", "1000", "1000", "1000", "1001", "0110"],
    "M": ["10001", "11011", "10101", "10101", "10001", "10001", "10001"],
    "Y": ["10001", "10001", "01010", "00100", "00100", "00100", "00100"],
    "y": ["0000", "0000", "1001", "1001", "0110", "0010", "1100"],
    "l": ["10", "10", "10", "10", "10", "10", "01"],
    "g": ["0000", "0000", "0111", "1001", "0111", "0001", "0110"],
    "0": ["0110", "1001", "1011", "1101", "1001", "1001", "0110"],
    "1": ["010", "110", "010", "010", "010", "010", "111"],
    "2": ["0110", "1001", "0001", "0010", "0100", "1000", "1111"],
    "3": ["0110", "1001", "0001", "0110", "0001", "1001", "0110"],
    "4": ["0010", "0110", "1010", "1111", "0010", "0010", "0010"],
    "5": ["1111", "1000", "1110", "0001", "0001", "1001", "0110"],
    "6": ["0110", "1000", "1110", "1001", "1001", "1001", "0110"],
    "7": ["1111", "0001", "0010", "0010", "0100", "0100", "0100"],
    "8": ["0110", "1001", "1001", "0110", "1001", "1001", "0110"],
    "9": ["0110", "1001", "1001", "0111", "0001", "0001", "0110"],
    "%": ["11001", "11010", "00010", "00100", "01000", "01011", "10011"],
    ".": ["0", "0", "0", "0", "0", "1", "1"],
    " ": ["00", "00", "00", "00", "00", "00", "00"],
}


def text_mask(s: str, scale: int = 1) -> np.ndarray:
    """Rasterize a string to a bool mask (7*scale rows)."""
    cols: list[np.ndarray] = []
    for ch in s:
        glyph = _FONT.get(ch)
        if glyph is None:
            glyph = _FONT[" "]
        g = np.array([[c == "1" for c in row] for row in glyph], dtype=bool)
        cols.append(g)
        cols.append(np.zeros((7, 1), dtype=bool))
    if not cols:
        return np.zeros((7, 0), dtype=bool)
    m = np.concatenate(cols[:-1], axis=1)
    if scale > 1:
        m = np.repeat(np.repeat(m, scale, axis=0), scale, axis=1)
    return m


class OverlayCanvas:
    """RGBA u8 accumulation canvas for precomputed graticule overlays."""

    def __init__(self, height: int, width: int):
        self.rgba = np.zeros((height, width, 4), dtype=np.uint8)

    def _put(self, ys, xs, color):
        h, w = self.rgba.shape[:2]
        ys = np.asarray(ys)
        xs = np.asarray(xs)
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        self.rgba[ys[ok], xs[ok]] = np.asarray(color, dtype=np.uint8)

    def line(self, x0: float, y0: float, x1: float, y1: float, color) -> None:
        """1px line rasterized like GPU GS_LINES (DDA over the major axis).

        The epsilon keeps the walk exact where dx*k/n is mathematically an
        integer: float64 rounding can land a hair below it (31/39*39 =
        30.999...) and floor() then drops a pixel, leaving width-dependent
        holes in axis-aligned lines a GPU draws solid.
        """
        dx, dy = x1 - x0, y1 - y0
        n = int(max(abs(dx), abs(dy)) + 0.5)
        if n == 0:
            self._put(
                np.array([int(np.floor(y0))]), np.array([int(np.floor(x0))]), color
            )
            return
        t = np.arange(n + 1, dtype=np.float64) / n
        xs = np.floor(x0 + dx * t + 1e-7).astype(np.int64)
        ys = np.floor(y0 + dy * t + 1e-7).astype(np.int64)
        self._put(ys, xs, color)

    def hline(self, y: float, x0: float, x1: float, color) -> None:
        self.line(x0, y, x1, y, color)

    def vline(self, x: float, y0: float, y1: float, color) -> None:
        self.line(x, y0, x, y1, color)

    def rect_fill(self, x0: int, y0: int, x1: int, y1: int, color) -> None:
        h, w = self.rgba.shape[:2]
        x0, x1 = max(0, int(x0)), min(w, int(x1))
        y0, y1 = max(0, int(y0)), min(h, int(y1))
        if x1 > x0 and y1 > y0:
            self.rgba[y0:y1, x0:x1] = np.asarray(color, dtype=np.uint8)

    def text(self, s: str, x: int, y: int, color, scale: int = 1) -> None:
        m = text_mask(s, scale)
        ys, xs = np.nonzero(m)
        self._put(ys + int(y), xs + int(x), color)

    def image_fit(self, img: np.ndarray, x: int, y: int, w: int, h: int) -> None:
        """Nearest-neighbor place an RGBA image into a rect."""
        if w <= 0 or h <= 0:
            return
        sy = (np.arange(h) * img.shape[0]) // h
        sx = (np.arange(w) * img.shape[1]) // w
        patch = img[sy][:, sx]
        H, W = self.rgba.shape[:2]
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(W, x + w), min(H, y + h)
        if x1 > x0 and y1 > y0:
            self.rgba[y0:y1, x0:x1] = patch[y0 - y : y1 - y, x0 - x : x1 - x]


def alpha_blend_u8(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Canonical integer srcalpha/invsrcalpha blend (golden-model side)."""
    a = src[..., 3:4].astype(np.uint32)
    s = src[..., :3].astype(np.uint32)
    d = dst[..., :3].astype(np.uint32)
    rgb = (s * a + d * (255 - a) + 127) // 255
    out = dst.copy()
    out[..., :3] = rgb.astype(np.uint8)
    return out
