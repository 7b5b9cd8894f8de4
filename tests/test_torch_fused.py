"""The port's ops.fused.analyze on the CPU vs JAX analyze on the CPU, over
the flag sets that pick K1+K2 (JAX's fast path) and the K6, K7 and K8 modes
of K2, for rgba, packed and planar input, with and without a static rect
(exact)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu.ops.fused import analyze as jax_analyze
from obs_color_monitor_tpu_torch.ops import fused as tfused

torch.set_num_threads(1)

H, W = 38, 54
FLAGS = {
    "k2_rgb": dict(need_vs=True, need_wv_rgb=True, need_hi_rgb=True),
    "k2_yuv": dict(need_vs=True, need_wv_yuv=True),
    "k6_both": dict(need_vs=True, need_wv_rgb=True, need_hi_yuv=True),
    "k7_vs": dict(need_vs=True),
    "k8_rgb": dict(need_wv_rgb=True, need_hi_rgb=True),
    "k8_yuv": dict(need_hi_yuv=True),
}
# the K2 modes each flag set launches: (need_vs, need_wv) per call
MODES = {
    "k2_rgb": [(True, True)],
    "k2_yuv": [(True, True)],
    "k6_both": [(True, True), (False, True)],
    "k7_vs": [(True, False)],
    "k8_rgb": [(False, True)],
    "k8_yuv": [(False, True)],
}
FIELDS = ("yuv_planes", "vs_counts", "wv_rgb", "wv_yuv", "hi_rgb", "hi_yuv", "planes")


def _frame(seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (H, W, 4), np.uint8)
    f[..., 3] = np.where(rng.random((H, W)) < 0.15, 0, 255)
    return f


def _as(f, fmt):
    if fmt == "packed":
        return f.view(np.uint32)[..., 0]
    if fmt == "planar":
        return np.ascontiguousarray(np.moveaxis(f, -1, 0))
    return f


@pytest.mark.parametrize("rect", [None, (3, 2, 20, 15)])
@pytest.mark.parametrize("fmt", ["rgba", "packed", "planar"])
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_analyze_matches_jax(flags, fmt, rect):
    f = _frame(len(flags) + len(fmt))
    x = _as(f, fmt)
    kw = dict(cs=1 + (len(flags) % 2), scale=2 + (fmt == "planar"), rect=rect,
              is_planar=fmt == "planar", **FLAGS[flags])
    ref = jax_analyze(jnp.asarray(x), is_packed=fmt == "packed", tm=1.5, **kw)
    tx = torch.from_numpy(x.view(np.int32) if fmt == "packed" else x)
    got = tfused.analyze(tx, **kw)
    for name in FIELDS:
        a, b = getattr(ref, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = np.asarray(a)
            assert np.array_equal(a.astype(np.int64), b.numpy().astype(np.int64)), name
            assert a.shape == tuple(b.shape), name


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_analyze_picks_the_k2_mode(flags, monkeypatch):
    """Each flag set runs K2 in the mode of the TPU kernel it stands in
    for: both counts (K2 / K6), the vectorscope alone (K7) or the waveform
    alone (K8)."""
    calls = []
    real = tfused.vs_wv_counts

    def spy(*args, need_vs=True, need_wv=True, rect=None):
        calls.append((need_vs, need_wv))
        return real(*args, need_vs=need_vs, need_wv=need_wv, rect=rect)

    monkeypatch.setattr(tfused, "vs_wv_counts", spy)
    rect = (2, 2, 20, 15) if flags == "k6_both" else None
    tfused.analyze(torch.from_numpy(_frame(3)), cs=2, scale=2, rect=rect, **FLAGS[flags])
    assert calls == MODES[flags]


def test_dynamic_rect_names_the_roadmap_item():
    # The name dates from when rect_dyn was refused with its ROADMAP item;
    # it no longer describes the test.  The test now checks that rect_dyn
    # counts the in-rect pixels of the full capture and excludes a static
    # rect (tests/test_torch_dynamic_roi.py covers the rest).
    f = torch.from_numpy(_frame(0))
    got = tfused.analyze(f, cs=2, need_vs=True, rect_dyn=torch.tensor([0, 0, 4, 4]))
    assert int(got.vs_counts.to(torch.int64).sum()) == 16
    assert tuple(got.planes.shape) == (4, H, W)
    with pytest.raises(ValueError):
        tfused.analyze(f, cs=2, need_vs=True, rect=(0, 0, 4, 4),
                       rect_dyn=torch.tensor([0, 0, 4, 4]))
