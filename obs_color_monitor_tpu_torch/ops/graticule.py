"""Graticule / key-legend overlay generation (host-side, precomputed).

A numpy port of ``obs_color_monitor_tpu/ops/graticule.py`` (the JAX
package cannot import it without JAX): the same functions, built on the
port's own ``golden`` and ``utils/draw``.  ``tests/test_torch_graticule.py``
holds every array equal to the original's.

Graticules only change when settings or colorspace change, so they are
rasterized once into RGBA u8 overlay arrays and alpha-blended over the scope
image (the reference rebuilds GPU vertex buffers under the same conditions,
src/vectorscope.c:267-269, src/waveform.c:378-382, src/histogram.c:560-565).

Coordinate data: the vectorscope target-box table is the FFmpeg-derived
coordinate data the reference embeds (src/vectorscope.c:283-314) — it is
*data* (where the 75%/100% color targets sit in CbCr space), kept verbatim
for visual parity.  Everything else is drawn procedurally (labels use the
built-in bitmap font instead of the reference's PNG atlases).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..colorspace import Colorspace, rgb2uv_int
from ..config import ShowKey
from ..utils.draw import OverlayCanvas, alpha_blend_u8
from ..golden.reference import falsecolor as golden_falsecolor

VS_SIZE = 256

# Amber/green graticule colors; the reference passes 0x80FFBF00 / 0x8000FF00
# to gs_effect_set_color (0xAARRGGBB) => RGBA (255,191,0,128) / (0,255,0,128)
# (reference src/vectorscope.c:184-190, src/waveform.c:334).
AMBER = (255, 191, 0, 128)
GREEN = (0, 255, 0, 128)

# CbCr positions of the 100% (entries 0-5: R,B,Cy,Yl,G,Mg) and 75% color
# targets, per colorspace — the FFmpeg vectorscope table embedded by the
# reference (src/vectorscope.c:283-314).  (u, v) with v up.
_VS_TARGETS = {
    Colorspace.BT601: [
        (90, 240), (240, 110), (166, 16), (16, 146), (54, 34), (202, 222),
        (44, 142), (156, 44), (72, 58), (184, 198), (100, 212), (212, 114),
    ],
    Colorspace.BT709: [
        (102, 240), (240, 118), (154, 16), (16, 138), (42, 26), (214, 230),
        (212, 120), (109, 212), (193, 204), (63, 52), (147, 44), (44, 136),
    ],
}

# Labels for targets 0-5 in table order (derived from the integer RGB->UV
# macros: e.g. BT601 R@100% -> u=91,v=239 ~ entry (90,240)).
_VS_LABELS = ["R", "B", "Cy", "Yl", "G", "Mg"]

# Corner-mark segment offsets around each target box
# (reference src/vectorscope.c:337-345): 8 segments of an open square.
_BOX_SEGS = [
    ((-6, -6), (-2, -6)), ((-6, -6), (-6, -2)),
    ((+6, -6), (+2, -6)), ((+6, -6), (+6, -2)),
    ((-6, +6), (-2, +6)), ((-6, +6), (-6, +2)),
    ((+6, +6), (+2, +6)), ((+6, +6), (+6, +2)),
]


@functools.lru_cache(maxsize=32)
def vectorscope_graticule(
    graticule: int, skintone_color: int, cs: int
) -> np.ndarray | None:
    """256x256 RGBA overlay: labels + target boxes + skin-tone/IQ lines.

    Mirrors create_graticule_vbuf (reference src/vectorscope.c:267-380).
    ``graticule`` is the GraticuleColor value (low bits color, bit 256 IQ);
    ``skintone_color`` is BGR like the reference's property.
    """
    g = int(graticule)
    if (g & 3) == 0:
        return None
    cs = Colorspace(cs)
    color = AMBER if (g & 3) == 1 else GREEN
    iq = bool(g & 256)
    canvas = OverlayCanvas(VS_SIZE, VS_SIZE)
    pts = _VS_TARGETS[cs]

    # labels (placement rules: reference src/vectorscope.c:318-331)
    for i in range(6):
        x = float(pts[i][0])
        y = 256.0 - pts[i][1]
        if x < 72:
            y += 20
        elif x > 184:
            y -= 20
        elif y > 128:
            x += 20
        else:
            x -= 20
        m_w = len(_VS_LABELS[i]) * 5
        canvas.text(_VS_LABELS[i], int(x - m_w // 2), int(y - 3), color)

    # corner boxes at all 12 targets
    for u, v in pts:
        x, y = float(u), 256.0 - v
        for (ax, ay), (bx, by) in _BOX_SEGS:
            canvas.line(x + ax, y + ay, x + bx, y + by, color)

    # skin-tone line (reference src/vectorscope.c:348-376)
    b = (skintone_color >> 16) & 0xFF
    gch = (skintone_color >> 8) & 0xFF
    r = skintone_color & 0xFF
    stl_u, stl_v = rgb2uv_int(r, gch, b, cs)
    stl_u, stl_v = float(stl_u), float(stl_v)
    norm = math.hypot(stl_u - 128.0, stl_v - 128.0)
    if norm > 1.0:
        stl_u = (stl_u - 128.0) * 128.0 / norm + 128.0
        stl_v = (stl_v - 128.0) * 128.0 / norm + 128.0
        if iq:
            canvas.line(255.0 - stl_u, stl_v, stl_u, 255.0 - stl_v, color)
            canvas.line(stl_v, stl_u, 255.0 - stl_v, 255.0 - stl_u, color)
        else:
            canvas.line(127.5, 127.5, stl_u, 255.0 - stl_v, color)
    return canvas.rgba


@functools.lru_cache(maxsize=64)
def waveform_graticule(
    lines: int, width: int, display: int, n_components: int
) -> np.ndarray | None:
    """Horizontal amber lines at 256*i/lines (reference src/waveform.c:291-332).

    Sized to the final waveform image (stack repeats per band; parade
    stretches across all bands).
    """
    if lines <= 0:
        return None
    from ..config import DisplayMode

    disp = DisplayMode(display)
    n = n_components
    h = 256 * (n if disp == DisplayMode.STACK else 1)
    w = width * (n if disp == DisplayMode.PARADE else 1)
    canvas = OverlayCanvas(h, w)
    n_stack = n if disp == DisplayMode.STACK else 1
    for band in range(n_stack):
        yoff = 256.0 * band + (0.5 if disp == DisplayMode.STACK else 0.0)
        start = 1 if band else 0  # skip duplicated seam line (waveform.c:327)
        for i in range(start, lines + 1):
            y = yoff + 256.0 * i / lines
            canvas.hline(min(y, h - 1), 0, w - 1, AMBER)
    return canvas.rgba


@functools.lru_cache(maxsize=64)
def histogram_graticule(
    v_lines: int,
    h_step: float,
    level_height: int,
    display: int,
    n_components: int,
    level_fixed: int,
    level_ratio_permille: int,
    logscale: bool,
) -> np.ndarray | None:
    """Vertical/horizontal graticule (reference src/histogram.c:452-520).

    Horizontal lines only exist with a fixed/ratio level mode and a
    configured step (reference src/histogram.c:454-467): y_max is the level
    value, lines every ``h_step/y_max`` of the height, disabled under log
    scale or when denser than 1/64 of the height.
    """
    from ..config import DisplayMode

    disp = DisplayMode(display)
    n = n_components
    if logscale:
        y_max = 0.0
    elif level_fixed:
        y_max = float(level_fixed)
    elif level_ratio_permille:
        y_max = level_ratio_permille / 10.0
    else:
        y_max = 0.0
    y_step = h_step / y_max if (y_max > 0 and h_step > 0) else 0.0
    has_v = v_lines > 0
    has_h = y_step > 1.0 / 64.0  # GRATICULE_H_MAX (histogram.c:36,469)
    if not has_v and not has_h:
        return None

    h = level_height * (n if disp == DisplayMode.STACK else 1)
    w = 256 * (n if disp == DisplayMode.PARADE else 1)
    canvas = OverlayCanvas(h, w)
    n_parade = n if disp == DisplayMode.PARADE else 1
    n_stack = n if disp == DisplayMode.STACK else 1
    for j in range(n_stack):
        yoff = float(level_height * j)
        for i in range(n_parade):
            xoff = 256.0 * i if disp == DisplayMode.PARADE else 1.0
            first = True
            if has_v:
                for k in range(v_lines + 1):
                    # parade bands skip their seam line (histogram.c:512)
                    if disp == DisplayMode.PARADE and i and first:
                        first = False
                        continue
                    x = xoff + 256.0 * k / v_lines
                    canvas.vline(min(x, w - 1), yoff, yoff + level_height - 1, AMBER)
                    first = False
            if has_h:
                y = 1.0
                while y >= 0.0:
                    canvas.hline(
                        min(yoff + y * level_height, h - 1),
                        xoff,
                        xoff + 255.0,
                        AMBER,
                    )
                    y -= y_step
    return canvas.rgba


# False-color key legend placements (reference src/zebra.c:418-520):
# (x0, y0, x1, y1, xk, yk, cxk, cyk, bg_rgba, is_vertical) in fractions of
# the frame size; cyk/cxk are per-LSB gradient steps.
_KEY_DEFS = {
    ShowKey.LEFT: (0.01, 0.1, 0.09, 0.9, 0.06, 0.88, 0.025, -0.76 / 256, (0, 0, 0, 128), True),
    ShowKey.RIGHT: (0.91, 0.1, 0.99, 0.9, 0.96, 0.88, 0.025, -0.76 / 256, (0, 0, 0, 128), True),
    ShowKey.OUTSIDE: (1.00, 0.0, 1.10, 1.0, 1.06, 0.95, 0.03, -0.90 / 256, (0, 0, 0, 255), True),
    ShowKey.TOP: (0.1, 0.01, 0.9, 0.09, 0.12, 0.05, 0.76 / 256, -0.025, (0, 0, 0, 128), False),
    ShowKey.BOTTOM: (0.1, 0.91, 0.9, 0.99, 0.12, 0.95, 0.76 / 256, -0.025, (0, 0, 0, 128), False),
    ShowKey.BELOW: (0.0, 1.00, 1.0, 1.20, 0.05, 1.08, 0.90 / 256, -0.060, (0, 0, 0, 255), False),
}


def key_canvas_size(show_key: ShowKey, width: int, height: int) -> tuple[int, int]:
    """Output size incl. OUTSIDE/BELOW extension (reference src/zebra.c:316-334)."""
    w, h = width, height
    if show_key == ShowKey.OUTSIDE:
        w = w * 11 // 10
    if show_key == ShowKey.BELOW:
        h = h * 12 // 10
    return w, h


def _key_gradient_rgba(cs: Colorspace, lut: np.ndarray | None) -> np.ndarray:
    """The legend's gradient bar: a 256-step gray ramp pushed through the
    false-color mapping itself (reference zb_create_key_tex src/zebra.c:367-383
    + drawing it with the falsecolor technique)."""
    ramp = np.zeros((1, 256, 4), dtype=np.uint8)
    ramp[0, :, 0] = ramp[0, :, 1] = ramp[0, :, 2] = np.arange(256)
    ramp[..., 3] = 255
    return golden_falsecolor(ramp, cs, lut=lut)[0]  # (256, 4)


def falsecolor_key_overlay(
    show_key: ShowKey,
    width: int,
    height: int,
    cs: Colorspace,
    lut_key: tuple | None = None,
    lut: np.ndarray | None = None,
) -> np.ndarray | None:
    """Key-legend overlay at the final output size (reference src/zebra.c:385-597).

    Background box, the false-colored gradient bar, and 0..100 labels every
    10% along the bar.  Returns RGBA (H', W', 4) or None.  ``lut_key``
    (JAX's cache key of the LUT) does not change the drawing; ``lut`` does.
    """
    show_key = ShowKey(show_key)
    if show_key == ShowKey.NONE:
        return None
    (x0, y0, x1, y1, xk, yk, cxk, cyk, bg, vertical) = _KEY_DEFS[show_key]
    out_w, out_h = key_canvas_size(show_key, width, height)
    canvas = OverlayCanvas(out_h, out_w)

    canvas.rect_fill(x0 * width, y0 * height, x1 * width, y1 * height, bg)

    grad = _key_gradient_rgba(cs, lut)  # (256, 4)
    if vertical:
        # bar runs bottom-to-top: value i at y = (yk + cyk*i) * height
        ytop = (yk + cyk * 255) * height
        ybot = yk * height
        bar_h = max(1, int(round(ybot - ytop)))
        bar_w = max(1, int(round(0.02 * width)))
        img = grad[::-1][:, None, :]  # top = value 255
        canvas.image_fit(img, int(xk * width - bar_w / 2), int(round(ytop)), bar_w, bar_h)
    else:
        xleft = xk * width
        xright = (xk + cxk * 255) * width
        bar_w = max(1, int(round(xright - xleft)))
        bar_h = max(1, int(round(0.02 * height)))
        img = grad[None, :, :]
        canvas.image_fit(img, int(round(xleft)), int(yk * height - bar_h / 2), bar_w, bar_h)

    # labels 0,10,...,100 along the bar (reference src/zebra.c:546-594)
    for i in range(11):
        label = str(i * 10)
        if vertical:
            x = int(x0 * width) + 1
            y = int((yk + cyk * 256 * i / 10) * height) - 3
        else:
            x = int((xk + cxk * 256 * i / 10) * width) - len(label) * 3
            y = int(yk * height) + int(0.02 * height) + 2
        canvas.text(label, x, y, (255, 255, 255, 255))
    return canvas.rgba


def histogram_step_choices(val_min: float, val_max: float) -> list[float]:
    """The 1/2/5-sequence choices for the histogram's horizontal graticule
    step combo (reference graticule_horizontal_combo_init,
    src/histogram.c:196-215).  -1.0 means None."""
    out = [-1.0]
    div = 1.0
    while val_min * div < 1.0:
        div *= 10.0
    ten = 1.0
    while ten / div <= val_max:
        for f in (1.0, 2.0, 5.0):
            v = f * ten / div
            if v < val_min:
                continue
            if v > val_max:
                break
            out.append(v)
        ten *= 10.0
    return out


def composite_overlay(image: np.ndarray, overlay: np.ndarray | None) -> np.ndarray:
    """Golden-side composite; the device side uses ops.render.blend_overlay."""
    if overlay is None:
        return image
    return alpha_blend_u8(image, overlay)
