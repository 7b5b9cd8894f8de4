"""Port ops.convert vs JAX ops.convert vs the golden model (exact)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.ops import convert as jconv
from obs_color_monitor_tpu_torch.ops import convert as tconv

torch.set_num_threads(1)


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[0, :4] = [(0, 0, 0, 255), (255, 255, 255, 255), (128, 128, 128, 0), (255, 0, 0, 0)]
    return f


def test_planarize_and_packed_views(small_frame):
    f = small_frame
    planes = tconv.planarize(torch.from_numpy(f))
    assert np.array_equal(planes.numpy(), np.asarray(jconv.planarize(jnp.asarray(f))))
    packed = tconv.host_packed_view(f)
    jpacked = jconv.host_packed_view(f)
    assert packed.dtype == jpacked.dtype == np.uint32 and packed.shape == f.shape[:2]
    assert np.array_equal(packed, jpacked)
    from_packed = tconv.planarize_packed(torch.from_numpy(packed.view(np.int32)))
    assert np.array_equal(from_packed.numpy(), planes.numpy())
    # the uint32 array, and a uint32 tensor, are taken as the same bytes
    assert torch.equal(tconv.planarize_packed(packed), from_packed)
    u32 = torch.from_numpy(packed.copy())
    assert torch.equal(tconv.planarize_packed(u32), from_packed)
    back = tconv.planes_to_rgba(planes)
    assert np.array_equal(back.numpy(), f)
    assert np.array_equal(
        back.numpy(), np.asarray(jconv.planes_to_rgba(jnp.asarray(planes.numpy())))
    )
    assert np.array_equal(tconv.interleave(planes).numpy(), f)


@pytest.mark.parametrize("cs", [1, 2])
def test_yuv_and_luma(small_frame, cs):
    f = small_frame
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0)))
    jp = jnp.asarray(planes.numpy())
    yuv = tconv.rgb_to_yuv_planes(planes, cs)
    assert np.array_equal(yuv.numpy(), np.asarray(jconv.rgb_to_yuv_planes(jp, cs=cs)))
    assert np.array_equal(np.moveaxis(yuv.numpy(), 0, -1), golden.rgb_to_yuv_u8(f, cs))
    luma = tconv.luma_planes(planes, cs)
    assert luma.dtype == torch.int32
    jl = np.asarray(jconv.luma_planes(jp, cs=cs))
    assert np.array_equal(luma.numpy(), jl.astype(np.int64))


@pytest.mark.parametrize("shape", [(48, 64), (131, 270)])
@pytest.mark.parametrize("scale", [1, 2, 3, 4, 5, 6, 7, 8, 16, 32])
def test_downscale_every_scale(shape, scale):
    h, w = shape
    f = _frame(h, w, h * w + scale)
    planes = np.ascontiguousarray(np.moveaxis(f, -1, 0))
    got = tconv.downscale_planes(torch.from_numpy(planes), scale).numpy()
    gold = golden.downscale(f, scale)
    assert np.array_equal(np.moveaxis(got, 0, -1), gold)
    jax_ds = np.asarray(jconv.downscale_planes(jnp.asarray(planes), scale=scale))
    assert np.array_equal(got, jax_ds)


def test_downscale_too_small_raises():
    with pytest.raises(ValueError):
        tconv.downscale_planes(torch.zeros((4, 8, 8), dtype=torch.uint8), 16)


def test_roi_crop():
    p = torch.arange(4 * 6 * 8, dtype=torch.int32).view(4, 6, 8).to(torch.uint8)
    got = tconv.roi_crop_planes(p, 1, 2, 5, 6)
    ref = jconv.roi_crop_planes(jnp.asarray(p.numpy()), 1, 2, 5, 6)
    assert np.array_equal(got.numpy(), np.asarray(ref))
