"""Port ops.stats vs JAX ops.stats vs the golden model.

Exact everywhere except logscale histogram levels: float32 ``log`` may
differ in the last bits between libraries, held to rtol 1e-4 as
tests/test_stats_bitexact.py holds the JAX version.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.config import Components
from obs_color_monitor_tpu.ops import stats as jst
from obs_color_monitor_tpu_torch.ops import stats as tst
from obs_color_monitor_tpu_torch.ops.convert import rgb_to_yuv_planes
from obs_color_monitor_tpu_torch.ops.scope_stats import histogram_from_waveform

torch.set_num_threads(1)


def _inputs(small_frame, yuv_mode):
    """(frame, planar data (3,H,W), mask or None, JAX mask) for a family."""
    f = small_frame
    p = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0)))
    yuv = rgb_to_yuv_planes(p, 2)
    data, mask = tst.select_planes(p, yuv, yuv_mode)
    jmask = np.ones(f.shape[:2], bool) if mask is None else mask.numpy() != 0
    return f, data, mask, jmask


def test_alpha_zero_pixels_planted(small_frame):
    assert (small_frame[..., 3] == 0).sum() > 10  # the fixture's alpha-0 pixels


def test_vectorscope(small_frame):
    f = small_frame
    p = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0)))
    yuv = rgb_to_yuv_planes(p, 2)
    got = tst.vectorscope_counts_i32(yuv)
    assert got.dtype == torch.int32
    assert int(got.sum()) == f.shape[0] * f.shape[1]  # alpha-0 pixels count
    ref = jst.vectorscope_counts_i32(jnp.asarray(yuv.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    sat = tst.saturate_u8(got).numpy()
    assert np.array_equal(sat, golden.vectorscope_counts(golden.rgb_to_yuv_u8(f, 2)))


@pytest.mark.parametrize("yuv_mode", [False, True])
def test_waveform_and_histogram(small_frame, yuv_mode):
    f, data, mask, jmask = _inputs(small_frame, yuv_mode)
    comps = Components.YUV if yuv_mode else Components.RGB
    yuv_img = golden.rgb_to_yuv_u8(f, 2)
    wv = tst.waveform_counts_i32(data, mask)
    jwv = jst.waveform_counts_i32(jnp.asarray(data.numpy()), jnp.asarray(jmask))
    assert np.array_equal(wv.numpy(), np.asarray(jwv))
    assert np.array_equal(
        tst.saturate_u8(wv).numpy(), golden.waveform_counts(f, yuv_img, comps)
    )
    hi = tst.histogram_counts(data, mask)
    jhi = jst.histogram_counts(jnp.asarray(data.numpy()), jnp.asarray(jmask))
    assert np.array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
    assert np.array_equal(hi.numpy(), golden.histogram_counts(f, yuv_img, comps))
    assert np.array_equal(histogram_from_waveform(wv).numpy(), hi.numpy())


def _counts():
    rng = np.random.default_rng(3)
    c = rng.integers(0, 5000, (3, 256)).astype(np.int32)
    c[1, 7] = 123457
    return c


@pytest.mark.parametrize(
    "comps,level_fixed,permille,n_pixels",
    [
        (Components.RGB, 0, 0, 96 * 64),  # auto: per-channel max
        (Components.UV, 0, 0, 96 * 64),  # auto, one channel disabled
        (Components.RGB, 1000, 0, 96 * 64),  # fixed pixel level
        (Components.RGB, 0, 100, 96 * 64),  # ratio
        (Components.RGB, 0, 1000, 3840 * 2160),  # ratio past the u32 product
        (Components.YUV, 0, 333, 3840 * 2160),
    ],
)
def test_hi_max(comps, level_fixed, permille, n_pixels):
    sel = comps.channel_select()
    counts = tst.apply_channel_select(torch.from_numpy(_counts()), sel)
    got = tst.histogram_hi_max(counts, sel, n_pixels, level_fixed, permille)
    ref = jst.histogram_hi_max(
        jnp.asarray(counts.numpy()), sel, n_pixels, level_fixed, permille
    )
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    gold = golden.histogram_hi_max(counts.numpy(), comps, n_pixels, 1, level_fixed, permille)
    assert np.array_equal(got.numpy(), gold.astype(np.int64))


@pytest.mark.parametrize("comps", [Components.RGB, Components.UV])
@pytest.mark.parametrize("logscale", [False, True])
def test_levels(comps, logscale):
    sel = comps.channel_select()
    counts = tst.apply_channel_select(torch.from_numpy(_counts()), sel)
    hi = tst.histogram_hi_max(counts, sel, 0, 0, 0)
    lv, hi_eff = tst.histogram_levels(counts, hi, sel, logscale)
    jlv, jhi = jst.histogram_levels(
        jnp.asarray(counts.numpy()), jnp.asarray(hi.numpy().astype(np.uint32)), sel, logscale
    )
    glv, ghi = golden.histogram_levels(counts.numpy(), hi.numpy().astype(np.uint32), comps, logscale)
    assert lv.dtype == torch.float32
    np.testing.assert_array_equal(hi_eff.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(hi_eff.numpy(), ghi)
    if logscale:
        np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), rtol=1e-4)
        np.testing.assert_allclose(lv.numpy(), glv, rtol=1e-4)
    else:
        np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
        np.testing.assert_array_equal(lv.numpy(), glv)


def test_channel_select():
    c = torch.ones((3, 256, 5), dtype=torch.int32)
    got = tst.apply_channel_select(c, (True, False, True))
    ref = jst.apply_channel_select(jnp.ones((3, 256, 5), jnp.int32), (True, False, True))
    assert np.array_equal(got.numpy(), np.asarray(ref))
