"""The scopes' graticules as RGBA u8 overlays (the reference's
create_graticule_vbuf, ``src/vectorscope.c:267-380``,
``src/waveform.c:291-332``, ``src/histogram.c:452-520``), drawn by the
benchmark's own rasterizer.  The vectorscope's target boxes are the
FFmpeg-derived table that the reference embeds (``src/vectorscope.c:283-314``).
"""

from __future__ import annotations

import math

from .draw import Canvas

AMBER = (255, 191, 0, 128)  # 0x80FFBF00 as RGBA
GREEN = (0, 255, 0, 128)  # 0x8000FF00 as RGBA

BT601, BT709 = 1, 2

# CbCr (u, v) of the 100 % (R, B, Cy, Yl, G, Mg) and the 75 % targets, v up
_VS_TARGETS = {
    BT601: [(90, 240), (240, 110), (166, 16), (16, 146), (54, 34), (202, 222),
            (44, 142), (156, 44), (72, 58), (184, 198), (100, 212), (212, 114)],
    BT709: [(102, 240), (240, 118), (154, 16), (16, 138), (42, 26), (214, 230),
            (212, 120), (109, 212), (193, 204), (63, 52), (147, 44), (44, 136)],
}
_VS_LABELS = ["R", "B", "Cy", "Yl", "G", "Mg"]
# the open square drawn around each target (src/vectorscope.c:337-345)
_BOX_SEGS = [((-6, -6), (-2, -6)), ((-6, -6), (-6, -2)), ((6, -6), (2, -6)),
             ((6, -6), (6, -2)), ((-6, 6), (-2, 6)), ((-6, 6), (-6, 2)),
             ((6, 6), (2, 6)), ((6, 6), (6, 2))]


def rgb2uv_int(r: int, g: int, b: int, cs: int) -> tuple[int, int]:
    """The reference's integer RGB->UV macros (src/vectorscope.c:28-34),
    /1024 truncating as C does."""
    if cs == BT601:
        return (int((-150 * r - 296 * g + 448 * b) / 1024) + 128,
                int((448 * r - 374 * g - 72 * b) / 1024) + 128)
    return (int((-102 * r - 346 * g + 450 * b) / 1024) + 128,
            int((450 * r - 408 * g - 40 * b) / 1024) + 128)


def vectorscope(graticule: int, skintone_bgr: int, cs: int):
    """256x256 overlay: labels, target boxes, the skin-tone line (and the
    I/Q lines with bit 256), or None with no graticule colour."""
    if graticule & 3 == 0:
        return None
    color = AMBER if graticule & 3 == 1 else GREEN
    canvas = Canvas(256, 256)
    pts = _VS_TARGETS[cs]
    for i in range(6):
        x, y = float(pts[i][0]), 256.0 - pts[i][1]
        if x < 72:
            y += 20
        elif x > 184:
            y -= 20
        elif y > 128:
            x += 20
        else:
            x -= 20
        canvas.text(_VS_LABELS[i], int(x - len(_VS_LABELS[i]) * 5 // 2), int(y - 3), color)
    for u, v in pts:
        x, y = float(u), 256.0 - v
        for (ax, ay), (bx, by) in _BOX_SEGS:
            canvas.line(x + ax, y + ay, x + bx, y + by, color)
    b, g, r = (skintone_bgr >> 16) & 0xFF, (skintone_bgr >> 8) & 0xFF, skintone_bgr & 0xFF
    su, sv = (float(a) for a in rgb2uv_int(r, g, b, cs))
    norm = math.hypot(su - 128.0, sv - 128.0)
    if norm > 1.0:
        su = (su - 128.0) * 128.0 / norm + 128.0
        sv = (sv - 128.0) * 128.0 / norm + 128.0
        if graticule & 256:
            canvas.line(255.0 - su, sv, su, 255.0 - sv, color)
            canvas.line(sv, su, 255.0 - sv, 255.0 - su, color)
        else:
            canvas.line(127.5, 127.5, su, 255.0 - sv, color)
    return canvas.rgba


def waveform(lines: int, width: int):
    """Overlay display (one band): amber lines at 256*i/lines, or None."""
    if lines <= 0:
        return None
    canvas = Canvas(256, width)
    for i in range(lines + 1):
        y = 256.0 * i / lines
        canvas.line(0, min(y, 255), width - 1, min(y, 255), AMBER)
    return canvas.rgba


def histogram(v_lines: int, level_height: int):
    """Overlay display in AUTO level mode (no horizontal lines): vertical
    amber lines at 1 + 256*k/v_lines, or None."""
    if v_lines <= 0:
        return None
    canvas = Canvas(level_height, 256)
    for k in range(v_lines + 1):
        x = 1.0 + 256.0 * k / v_lines
        canvas.line(min(x, 255), 0.0, min(x, 255), level_height - 1.0, AMBER)
    return canvas.rgba
