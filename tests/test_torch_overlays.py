"""Port ops.overlays vs JAX ops.overlays vs the golden model (exact)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.colorspace import quantize_unorm8
from obs_color_monitor_tpu.golden.reference import peaking_threshold_fixed
from obs_color_monitor_tpu.ops import overlays as jov
from obs_color_monitor_tpu_torch.ops import overlays as tov

torch.set_num_threads(1)


def _bright_frame(seed=5):
    """Random frame biased bright, so the zebra window (luma >= 0.75) and
    every false-colour band are populated."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (37, 53, 4), np.uint8)
    f[::2, :, :3] = np.maximum(f[::2, :, :3], 190)
    f[5, :12, :3] = np.arange(0, 256, 22, dtype=np.uint8)[:12, None]
    return f


def _planar(f):
    return np.ascontiguousarray(np.moveaxis(f, -1, 0))


@pytest.mark.parametrize("tm", [0.0, 2.5, 11.9])
def test_zebra(tm):
    f = _bright_frame()
    p = _planar(f)
    got = tov.zebra_planes(torch.from_numpy(p), 0.75, 1.0, tm, 2).numpy()
    ref = jov.zebra_planes(jnp.asarray(p), th_low=0.75, th_high=1.0, tm=jnp.float32(tm), cs=2)
    assert np.array_equal(got, np.asarray(ref))
    assert np.array_equal(np.moveaxis(got, 0, -1), golden.zebra(f, 0.75, 1.0, tm, 2))
    assert (got[3] != p[3]).any()  # some stripes drawn


@pytest.mark.parametrize("cs", [1, 2])
def test_falsecolor(small_frame, cs):
    for f in (small_frame, _bright_frame()):
        p = _planar(f)
        got = tov.falsecolor_planes(torch.from_numpy(p), cs).numpy()
        assert np.array_equal(got, np.asarray(jov.falsecolor_planes(jnp.asarray(p), cs=cs)))
        assert np.array_equal(np.moveaxis(got, 0, -1), golden.falsecolor(f, cs))


@pytest.mark.parametrize("n", [2, 17, 256, 32768])
def test_falsecolor_lut(n):
    f = _bright_frame(n)
    p = _planar(f)
    rng = np.random.default_rng(n)
    lut = rng.integers(0, 256, (n, 4), np.uint8)
    got = tov.falsecolor_lut_planes(torch.from_numpy(p), torch.from_numpy(lut), 1, n).numpy()
    ref = jov.falsecolor_lut_planes(jnp.asarray(p), jnp.asarray(lut), cs=1, lut_n=n)
    assert np.array_equal(got, np.asarray(ref))
    assert np.array_equal(np.moveaxis(got, 0, -1), golden.falsecolor(f, 1, lut=lut))


@pytest.mark.parametrize("threshold", [0.001, 0.05, 0.1])
def test_focus_peaking(small_frame, threshold):
    f = small_frame
    p = _planar(f)
    th = peaking_threshold_fixed(threshold)
    rgba = (1.0, 84 / 255, 0.0, 1.0)
    color = quantize_unorm8(np.asarray(rgba, np.float32))
    got = tov.focus_peaking_planes(torch.from_numpy(p), th, color).numpy()
    ref = jov.focus_peaking_planes(jnp.asarray(p), th, jnp.asarray(color))
    assert np.array_equal(got, np.asarray(ref))
    assert np.array_equal(np.moveaxis(got, 0, -1), golden.focus_peaking(f, threshold, rgba))
