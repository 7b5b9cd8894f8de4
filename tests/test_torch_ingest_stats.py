"""K9's entry points, ``fused_ingest_stats_scale1/2``, in the port (K1's
scale launch, then K2; their plain versions on the CPU) vs JAX
``pallas_stats.fused_ingest_stats_scale1/2`` in Pallas interpret mode and vs
the golden model, bit for bit (the raw int32 counts against JAX, their
saturated u8 view against golden)."""

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu.ops import pallas_stats
from obs_color_monitor_tpu_torch import golden
from obs_color_monitor_tpu_torch.colorspace import Colorspace
from obs_color_monitor_tpu_torch.config import Components
from obs_color_monitor_tpu_torch.ops import pipeline as tp
from obs_color_monitor_tpu_torch.ops import scope_stats as ss

torch.set_num_threads(1)


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
    f[0, :4] = ((0, 0, 0, 255), (255, 255, 255, 255), (128, 128, 128, 255), (255, 0, 0, 0))
    return f


def _check_golden(f, scale, yuv_data, cs, vs, wv, ds=None):
    scaled = golden.downscale(f, scale) if scale > 1 else f
    yuv = golden.rgb_to_yuv_u8(scaled, Colorspace(cs))
    comp = Components.YUV if yuv_data else Components.RGB
    yuv_arg = yuv if yuv_data else None
    sat = lambda x: np.minimum(x.numpy(), 255).astype(np.uint8)
    assert np.array_equal(sat(vs), golden.vectorscope_counts(yuv))
    assert np.array_equal(sat(wv), golden.waveform_counts(scaled, yuv_arg, comp))
    assert np.array_equal(wv.sum(dim=-1).numpy().astype(np.uint32),
                          golden.histogram_counts(scaled, yuv_arg, comp))
    if ds is not None:
        assert np.array_equal(ds.numpy(), np.moveaxis(scaled, -1, 0))


# the shapes of tests/test_pallas_stats.py:88,120 plus 13x17 and 131x270;
# each runs through JAX once (an interpret-mode compile per case is the
# cost), with yuv_data alternating, and through golden both ways
SCALE2 = [(128, 256), (130, 190), (258, 514), (13, 17), (131, 270)]
SCALE1 = [(128, 128), (67, 190), (13, 17), (131, 270)]
JAX_CASES = [(2, s, i % 2 == 0) for i, s in enumerate(SCALE2)] + [
    (1, s, i % 2 == 1) for i, s in enumerate(SCALE1)]


def _port(scale, f, yuv_data, cs):
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0)))
    fn = tp.fused_ingest_stats_scale2 if scale == 2 else tp.fused_ingest_stats_scale1
    return fn(planes, cs, yuv_data=yuv_data)


@pytest.mark.parametrize("scale,shape,yuv_data", JAX_CASES)
def test_matches_jax(scale, shape, yuv_data):
    f = _frame(*shape, seed=shape[0] * shape[1] + scale)
    cs = 1 + int(yuv_data)
    got = _port(scale, f, yuv_data, cs)
    fn = (pallas_stats.fused_ingest_stats_scale2 if scale == 2
          else pallas_stats.fused_ingest_stats_scale1)
    ref = fn(np.ascontiguousarray(np.moveaxis(f, -1, 0)), cs=cs, yuv_data=yuv_data,
             interpret=True)
    assert len(got) == len(ref) == (3 if scale == 2 else 2)
    for name, a, b in zip(("vs", "wv", "ds"), got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape and a.numpy().dtype == b.dtype, name
        assert np.array_equal(a.numpy(), b), name


@pytest.mark.parametrize("yuv_data", [False, True])
@pytest.mark.parametrize("scale,shape", [(2, s) for s in SCALE2] + [(1, s) for s in SCALE1])
def test_matches_golden(scale, shape, yuv_data):
    f = _frame(*shape, seed=shape[0] + shape[1] + scale)
    cs = 2 - int(yuv_data)
    _check_golden(f, scale, yuv_data, cs, *_port(scale, f, yuv_data, cs))


def test_plain_route_and_checks():
    f = _frame(40, 64, 3)
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0)))
    launches = (tp.frame_pass.launches, ss.vs_wv_counts.launches)
    for a, b in zip(tp.fused_ingest_stats(planes, 2, 2, True),
                    tp.fused_ingest_stats_reference(planes, 2, 2, True)):
        assert torch.equal(a, b)
    # the CPU launches nothing
    assert (tp.frame_pass.launches, ss.vs_wv_counts.launches) == launches
    with pytest.raises(ValueError):
        tp.fused_ingest_stats(planes, 2, 3)
    with pytest.raises(ValueError):
        tp.fused_ingest_stats_scale2(planes[:3], 2)
