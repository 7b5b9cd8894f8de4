"""The port's interleaved boundary wrappers and re-exports against the JAX
package's: ``ops.convert.{downscale, rgb_to_yuv_u8, luma_fixed, roi_crop}``,
``ops.overlays.{zebra, falsecolor, falsecolor_lut, focus_peaking}``,
``ops.stats.{vectorscope_counts, waveform_counts}`` and
``ops.graticule.{histogram_step_choices, composite_overlay}`` on seeded
frames, odd shapes included (``tests/test_pipeline_kernel.py:36-49``), every
output equal; and every name of JAX's ``ops.__all__`` and
``parallel.__all__`` in the port's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import obs_color_monitor_tpu.models as jmodels
import obs_color_monitor_tpu.ops as jops
import obs_color_monitor_tpu.parallel as jpar
from obs_color_monitor_tpu.ops import convert as jconv
from obs_color_monitor_tpu.ops import graticule as jgrat
from obs_color_monitor_tpu.ops import overlays as jov
from obs_color_monitor_tpu.ops import stats as jstats
import obs_color_monitor_tpu_torch.models as tmodels
import obs_color_monitor_tpu_torch.ops as tops
import obs_color_monitor_tpu_torch.parallel as tpar
from obs_color_monitor_tpu_torch.ops import convert as tconv
from obs_color_monitor_tpu_torch.ops import graticule as tgrat
from obs_color_monitor_tpu_torch.ops import overlays as tov
from obs_color_monitor_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)

SHAPES = [(13, 17), (17, 33), (65, 144), (48, 64)]


def _rgba(h, w, seed=0):
    rng = np.random.default_rng(seed + 1000 * h + w)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
    f[: h // 3, :, :3] = np.maximum(f[: h // 3, :, :3], 200)  # zebra's window
    f[0, :4] = ((0, 0, 0, 255), (255, 255, 255, 255), (128, 128, 128, 255), (255, 0, 0, 0))
    return f


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(jops.__all__))
def test_ops_all_holds_jax_names(name):
    assert name in tops.__all__ and callable(getattr(tops, name))


@pytest.mark.parametrize("name", sorted(jpar.__all__))
def test_parallel_all_holds_jax_names(name):
    assert name in tpar.__all__ and hasattr(tpar, name)


# JAX's traced-render plumbing (a leaf tuple traced into the Dock's jitted
# stream program, and its cache key): the port's captured steps
# (``graphs.CapturedStep``) take its place, so no port class has it
TRACED_RENDER = {"render_leaves", "render_traced", "render_trace_key"}


@pytest.mark.parametrize("name", ["Vectorscope", "Waveform", "Histogram", "Zebra", "FalseColor",
                                  "FocusPeaking", "Dock"])
def test_models_classes_hold_jax_methods(name):
    public = lambda cls: {n for n in dir(cls) if not n.startswith("_")}
    missing = public(getattr(jmodels, name)) - TRACED_RENDER - public(getattr(tmodels, name))
    assert not missing, (name, sorted(missing))


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("scale", [1, 2, 3])
def test_downscale(h, w, scale):
    f = _rgba(h, w)
    _same(tconv.downscale(torch.from_numpy(f), scale), jconv.downscale(jnp.asarray(f), scale))


def test_downscale_too_small_raises():
    with pytest.raises(ValueError):
        tconv.downscale(torch.zeros((3, 5, 4), dtype=torch.uint8), 8)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("cs", [1, 2])
def test_rgb_to_yuv_u8_and_luma(h, w, cs):
    f = _rgba(h, w, cs)
    _same(tconv.rgb_to_yuv_u8(torch.from_numpy(f), cs), jconv.rgb_to_yuv_u8(jnp.asarray(f), cs))
    # JAX keeps the integer luma in float32; the port in int32
    got = tconv.luma_fixed(torch.from_numpy(f), cs)
    assert got.dtype == torch.int32
    _same(got, np.asarray(jconv.luma_fixed(jnp.asarray(f), cs)).astype(np.int32))


@pytest.mark.parametrize("rect", [(0, 0, 17, 13), (3, 2, 11, 9), (5, 5, 5, 9), (16, 12, 17, 13)])
def test_roi_crop(rect):
    f = _rgba(13, 17)
    _same(tconv.roi_crop(torch.from_numpy(f), *rect), jconv.roi_crop(jnp.asarray(f), *rect))


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("cs", [1, 2])
def test_overlay_wrappers(h, w, cs):
    f = _rgba(h, w, 7 + cs)
    t, j = torch.from_numpy(f), jnp.asarray(f)
    for tm in (0.0, 2.5, 1000.37):
        _same(tov.zebra(t, 0.5, 1.0, tm, cs), jov.zebra(j, 0.5, 1.0, jnp.float32(tm), cs))
    _same(tov.falsecolor(t, cs), jov.falsecolor(j, cs))
    for th in (0, 300, 3062):
        color = np.array([255, 84, 0, 255], np.uint8)
        _same(tov.focus_peaking(t, th, color),
              jov.focus_peaking(j, jnp.int32(th), jnp.asarray(color)))


@pytest.mark.parametrize("lut_n", [1, 7, 256, 1000])
def test_falsecolor_lut(lut_n):
    f = _rgba(17, 33, lut_n)
    lut = np.random.default_rng(lut_n).integers(0, 256, (lut_n, 4), np.uint8)
    for cs in (1, 2):
        _same(tov.falsecolor_lut(torch.from_numpy(f), torch.from_numpy(lut), cs, lut_n),
              jov.falsecolor_lut(jnp.asarray(f), jnp.asarray(lut), cs, lut_n))


@pytest.mark.parametrize("h,w", SHAPES + [(320, 24)])
def test_saturating_counts(h, w):
    f = _rgba(h, w, 3)
    saturating = h > 255
    if saturating:  # bins over 255: the counts saturate
        f[:, :8] = 128
    planes = np.ascontiguousarray(np.moveaxis(f, -1, 0))
    yuv = np.array(jconv.rgb_to_yuv_planes(jnp.asarray(planes), 2))
    mask = planes[3] != 0
    got_vs = tstats.vectorscope_counts(torch.from_numpy(yuv))
    assert got_vs.dtype == torch.uint8
    _same(got_vs, jstats.vectorscope_counts(jnp.asarray(yuv)))
    got_wv = tstats.waveform_counts(torch.from_numpy(planes[:3]), torch.from_numpy(mask))
    assert got_wv.dtype == torch.uint8
    _same(got_wv, jstats.waveform_counts(jnp.asarray(planes[:3]), jnp.asarray(mask)))
    if saturating:
        assert got_vs.max() == 255 and got_wv.max() == 255
    # the re-exports are the same functions
    assert tops.vectorscope_counts is tstats.vectorscope_counts
    assert tops.downscale is tconv.downscale


@pytest.mark.parametrize("vmin,vmax", [(1.0, 1000.0), (0.5, 20.0), (0.013, 0.5), (3.0, 3.0),
                                       (2.0, 1.0)])
def test_histogram_step_choices(vmin, vmax):
    assert tgrat.histogram_step_choices(vmin, vmax) == jgrat.histogram_step_choices(vmin, vmax)


def test_composite_overlay():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (20, 30, 4), np.uint8)
    ov = rng.integers(0, 256, (20, 30, 4), np.uint8)
    _same(tgrat.composite_overlay(img, ov), jgrat.composite_overlay(img, ov))
    assert tgrat.composite_overlay(img, None) is img
