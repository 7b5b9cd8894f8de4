"""Port ops.render vs JAX ops.render vs golden/render.py (exact)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu.golden import render as grender
from obs_color_monitor_tpu.ops import render as jrender
from obs_color_monitor_tpu_torch.ops import render as trender

torch.set_num_threads(1)

MODES = [(d, n, y) for d in (0, 1, 2) for n in (1, 2, 3) for y in (False, True)]


def _u8(shape, seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 256, shape, np.uint8)
    c[..., :40] = 0  # empty levels
    return c


@pytest.mark.parametrize("cs", [1, 2])
@pytest.mark.parametrize("white", [False, True])
def test_vectorscope(cs, white):
    c = _u8((256, 256), cs)
    got = trender.render_vectorscope(torch.from_numpy(c), 25, cs, white).numpy()
    assert got.shape == (256, 256, 4) and got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(jrender.render_vectorscope(jnp.asarray(c), 25, cs, white)))
    assert np.array_equal(got, grender.render_vectorscope(c, 25, cs, white))


@pytest.mark.parametrize("display,n,yuv", MODES)
def test_waveform(display, n, yuv):
    c = _u8((3, 256, 37), display * 7 + n)
    got = trender.render_waveform(torch.from_numpy(c), 51, display, n, yuv).numpy()
    ref = jrender.render_waveform(jnp.asarray(c), 51, display, n, yuv)
    assert np.array_equal(got, np.asarray(ref))
    assert np.array_equal(got, grender.render_waveform(c, 51, display, n, yuv))


@pytest.mark.parametrize("display,n,yuv", MODES)
def test_histogram(display, n, yuv):
    rng = np.random.default_rng(display * 7 + n)
    levels = rng.integers(0, 3000, (3, 256)).astype(np.float32)
    levels[:, :30] = 0
    hi = np.asarray([2999, 1500, 2500], np.float32)
    got = trender.render_histogram(
        torch.from_numpy(levels), torch.from_numpy(hi), 64, display, n, yuv
    ).numpy()
    ref = jrender.render_histogram(jnp.asarray(levels), jnp.asarray(hi), 64, display, n, yuv)
    assert np.array_equal(got, np.asarray(ref))
    assert np.array_equal(got, grender.render_histogram(levels, hi, 64, display, n, yuv))
