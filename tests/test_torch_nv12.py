"""The port's NV12/P010 decode on the CPU (the plain versions of kernels K4
and K5) vs JAX: the XLA ``nv12_to_packed`` and the Pallas kernels in
interpret mode, over the shapes and depths of tests/test_pallas_convert.py;
the dtype and geometry errors; ``nv12_shift`` (exact)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu.ops import convert as jconv
from obs_color_monitor_tpu.ops.pallas_convert import nv12_16_decode_pallas, nv12_decode_pallas
from obs_color_monitor_tpu_torch.ops import convert as tconv
from obs_color_monitor_tpu_torch.ops import decode as tdec

torch.set_num_threads(1)


def _planes(seed, h, w):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (h, w), np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), np.uint8)
    # fixed-point boundary samples: limited-range ends + neutral chroma
    y[0, :3] = (0, 16, 255)[: w]
    uv[0, :4] = (0, 255, 128, 128)[: w]
    return y, uv


def _planes16(seed, h, w, bits, msb):
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    y = rng.integers(0, hi, (h, w)).astype(np.uint16)
    uv = rng.integers(0, hi, (h // 2, w)).astype(np.uint16)
    y.flat[:3] = (513, 514, hi - 1) if bits == 10 else (0, 1, hi - 1)
    if msb:
        y, uv = (y << (16 - bits)).astype(np.uint16), (uv << (16 - bits)).astype(np.uint16)
    return y, uv


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("cs", [1, 2])
@pytest.mark.parametrize("h,w", [(64, 128), (48, 64), (130, 256), (2, 8), (66, 142)])
def test_decode_matches_jax(h, w, cs):
    y, uv = _planes(h * w + cs, h, w)
    got = tdec.nv12_decode(torch.from_numpy(y), torch.from_numpy(uv), cs=cs)
    assert got.dtype == torch.int32 and tuple(got.shape) == (h, w)
    ref = np.asarray(jconv.nv12_to_packed(jnp.asarray(y), jnp.asarray(uv), cs=cs))
    assert np.array_equal(_u32(got), ref)
    if w % 4 == 0:  # the TPU kernel's geometry
        pal = nv12_decode_pallas(jnp.asarray(y), jnp.asarray(uv), cs=cs, interpret=True)
        assert np.array_equal(_u32(got), np.asarray(pal))
    planes = tconv.nv12_to_planes(torch.from_numpy(y), torch.from_numpy(uv), cs=cs).numpy()
    assert np.array_equal(planes, np.asarray(jconv.nv12_to_planes(jnp.asarray(y),
                                                                  jnp.asarray(uv), cs=cs)))


@pytest.mark.parametrize("bits,msb", [(10, False), (10, True), (12, False), (16, False)])
@pytest.mark.parametrize("h,w", [(64, 128), (130, 254), (2, 4)])
def test_decode16_matches_jax(h, w, bits, msb):
    shift = tconv.nv12_shift(bits, msb)
    y16, uv16 = _planes16(h + bits, h, w, bits, msb)
    got = tdec.nv12_16_decode(torch.from_numpy(y16), torch.from_numpy(uv16), cs=2, shift=shift)
    xla = jconv.nv12_to_packed(jnp.asarray(y16), jnp.asarray(uv16), cs=2, shift=shift)
    assert np.array_equal(_u32(got), np.asarray(xla))
    pal = nv12_16_decode_pallas(jnp.asarray(y16), jnp.asarray(uv16), cs=2, shift=shift,
                                interpret=True)
    assert np.array_equal(_u32(got), np.asarray(pal))
    # the dispatcher picks K5 for shift > 0
    via = tconv.nv12_to_packed(torch.from_numpy(y16), torch.from_numpy(uv16), cs=2, shift=shift)
    assert torch.equal(via, got)


def test_wrong_dtype_rejected():
    y8, uv8 = (torch.from_numpy(a) for a in _planes(0, 16, 16))
    y16, uv16 = (torch.from_numpy(a) for a in _planes16(0, 16, 16, 10, False))
    with pytest.raises(TypeError, match="u8"):
        tconv.nv12_to_packed(y16, uv16)  # u16 without shift=
    with pytest.raises(TypeError, match="u16"):
        tconv.nv12_to_packed(y8, uv8, shift=2)  # u8 with shift
    with pytest.raises(TypeError, match="u8"):
        tdec.nv12_decode(y16, uv16)
    with pytest.raises(ValueError, match="1..8"):
        tdec.nv12_16_decode(y16, uv16, shift=9)


@pytest.mark.parametrize(
    "yshape,uvshape",
    [((15, 16), (7, 16)), ((16, 15), (8, 15)), ((16, 16), (4, 16)), ((16, 16), (8, 14))],
)
def test_bad_geometry_rejected(yshape, uvshape):
    y = torch.zeros(yshape, dtype=torch.uint8)
    uv = torch.zeros(uvshape, dtype=torch.uint8)
    with pytest.raises(ValueError, match="geometry"):
        tconv.nv12_to_packed(y, uv)


def test_nv12_shift_helper():
    assert tconv.nv12_shift(8) == 0
    assert tconv.nv12_shift(10) == 2
    assert tconv.nv12_shift(10, msb_aligned=True) == 8
    assert tconv.nv12_shift(16) == 8
    for bits in (8, 10, 12, 14, 16):
        for msb in (False, True):
            assert tconv.nv12_shift(bits, msb) == jconv.nv12_shift(bits, msb)
    with pytest.raises(ValueError, match="bits"):
        tconv.nv12_shift(9)


def test_wrappers_refuse_other_devices():
    y, uv = (torch.zeros(s, dtype=torch.uint8, device="meta") for s in ((4, 4), (2, 4)))
    with pytest.raises(ValueError, match="device"):
        tdec.nv12_decode(y, uv)
