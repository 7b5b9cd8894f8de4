"""The port's numpy graticules and false-colour key legends vs the JAX
package's ops/graticule.py (array equality)."""

import numpy as np
import pytest

from obs_color_monitor_tpu.ops import graticule as jg
from obs_color_monitor_tpu_torch.ops import graticule as tg


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("graticule", [0, 1, 2, 1 | 256, 2 | 256])
@pytest.mark.parametrize("cs", [1, 2])
def test_vectorscope_graticule(graticule, cs):
    for skin in (0x0054FF, 0x3070C0, 0x808080):
        assert _same(jg.vectorscope_graticule(graticule, skin, cs),
                     tg.vectorscope_graticule(graticule, skin, cs))


@pytest.mark.parametrize("lines", [0, 1, 4, 5, 10])
@pytest.mark.parametrize("display,n", [(0, 3), (1, 3), (2, 3), (1, 2), (2, 1)])
def test_waveform_graticule(lines, display, n):
    assert _same(jg.waveform_graticule(lines, 37, display, n),
                 tg.waveform_graticule(lines, 37, display, n))


@pytest.mark.parametrize(
    "v_lines,h_step,level_height,display,n,fixed,ratio,log",
    [
        (5, -1.0, 200, 0, 3, 0, 0, False),
        (0, -1.0, 200, 0, 3, 0, 0, False),
        (4, 500.0, 120, 1, 3, 3000, 0, False),
        (10, 2.0, 90, 2, 2, 0, 100, False),
        (2, 5.0, 64, 2, 3, 0, 250, True),
        (0, 50.0, 100, 0, 1, 1000, 0, False),
    ],
)
def test_histogram_graticule(v_lines, h_step, level_height, display, n, fixed, ratio, log):
    args = (v_lines, h_step, level_height, display, n, fixed, ratio, log)
    assert _same(jg.histogram_graticule(*args), tg.histogram_graticule(*args))


@pytest.mark.parametrize("show_key", range(7))
@pytest.mark.parametrize("w,h", [(64, 36), (192, 108), (33, 17)])
def test_key_canvas_and_legend(show_key, w, h):
    assert jg.key_canvas_size(show_key, w, h) == tg.key_canvas_size(show_key, w, h)
    for cs in (1, 2):
        assert _same(jg.falsecolor_key_overlay(show_key, w, h, cs),
                     tg.falsecolor_key_overlay(show_key, w, h, cs))
    lut = np.random.default_rng(show_key).integers(0, 256, (50, 4), np.uint8)
    assert _same(jg.falsecolor_key_overlay(show_key, w, h, 2, lut=lut),
                 tg.falsecolor_key_overlay(show_key, w, h, 2, lut=lut))
