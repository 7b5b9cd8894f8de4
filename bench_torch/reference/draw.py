"""Host rasterizer of the graticule overlays, the reference's own copy.

A copy of the program's 5x7 bitmap font, line walk and integer alpha blend
(the spec in ``doc/bit-exactness.md`` §11 and the reference's
``src/vectorscope.c:267-380``, ``src/waveform.c:291-332``,
``src/histogram.c:452-520``), kept here so that a change to the program
cannot move the yardstick.  NumPy on the host: a graticule is a constant
table drawn once per configuration.
"""

from __future__ import annotations

import numpy as np

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
    " ": ["00", "00", "00", "00", "00", "00", "00"],
}


def text_mask(s: str) -> np.ndarray:
    """A string as a (7, n) bool mask, one blank column between glyphs."""
    cols: list[np.ndarray] = []
    for ch in s:
        glyph = _FONT.get(ch, _FONT[" "])
        cols.append(np.array([[c == "1" for c in row] for row in glyph], dtype=bool))
        cols.append(np.zeros((7, 1), dtype=bool))
    if not cols:
        return np.zeros((7, 0), dtype=bool)
    return np.concatenate(cols[:-1], axis=1)


class Canvas:
    """An RGBA u8 overlay that lines and text are drawn into."""

    def __init__(self, height: int, width: int):
        self.rgba = np.zeros((height, width, 4), dtype=np.uint8)

    def _put(self, ys, xs, color) -> None:
        h, w = self.rgba.shape[:2]
        ys, xs = np.asarray(ys), np.asarray(xs)
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        self.rgba[ys[ok], xs[ok]] = np.asarray(color, dtype=np.uint8)

    def line(self, x0: float, y0: float, x1: float, y1: float, color) -> None:
        """A 1-px line walked over its major axis, as GS_LINES draws it; the
        epsilon keeps points whose exact position is an integer on it."""
        dx, dy = x1 - x0, y1 - y0
        n = int(max(abs(dx), abs(dy)) + 0.5)
        if n == 0:
            self._put([int(np.floor(y0))], [int(np.floor(x0))], color)
            return
        t = np.arange(n + 1, dtype=np.float64) / n
        xs = np.floor(x0 + dx * t + 1e-7).astype(np.int64)
        ys = np.floor(y0 + dy * t + 1e-7).astype(np.int64)
        self._put(ys, xs, color)

    def text(self, s: str, x: int, y: int, color) -> None:
        ys, xs = np.nonzero(text_mask(s))
        self._put(ys + int(y), xs + int(x), color)
