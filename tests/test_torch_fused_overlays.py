"""The plain version of kernel K3 (the port's fused_overlays_planes on the
CPU) vs JAX fused_overlays_planes in Pallas interpret mode, with and
without packed_out and a rect, and vs the JAX overlay ops (exact)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu.ops import overlays as jov
from obs_color_monitor_tpu.ops.pallas_overlays import fused_overlays_planes as jax_fused
from obs_color_monitor_tpu_torch.ops import fused_overlays as tfo

torch.set_num_threads(1)

KW = dict(th_low=0.75, th_high=1.0, zb_cs=2, fc_cs=1, peak_th=3062,
          peak_rgba=(255, 84, 0, 255))


def _planes(h, w, seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (4, h, w), np.uint8)
    p[:3, ::2] = np.maximum(p[:3, ::2], 190)  # populate the zebra window
    p[:3, h // 2:, : w // 3] = 128  # a flat region: no peaks
    p[3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
    return p


def _u32(x):
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize(
    "h,w,rect,tm",
    [
        (13, 17, None, 0.0),
        (37, 53, None, 2.5),
        (40, 64, (5, 3, 40, 30), 11.9),   # inside
        (33, 17, (0, 0, 17, 20), 7.25),   # touching the left, top and right edges
        (40, 48, (8, 9, 48, 40), 1.0),    # touching the right and bottom edges
    ],
)
def test_plain_k3_matches_pallas(h, w, rect, tm, packed_out):
    p = _planes(h, w, h * w)
    got = tfo.fused_overlays_planes(torch.from_numpy(p), tm, rect=rect, packed_out=packed_out,
                                    **KW)
    ref = jax_fused(jnp.asarray(p), jnp.float32(tm), rect=None if rect is None else
                    jnp.asarray(rect, jnp.int32), packed_out=packed_out, interpret=True, **KW)
    x0, y0, x1, y1 = rect if rect is not None else (0, 0, w, h)
    for g, r in zip(got, ref):
        g = _u32(g) if packed_out else g.numpy()
        r = np.asarray(r)
        assert g.shape == r.shape
        # inside the rect both are the overlays of the cropped frame; JAX
        # leaves the outside unspecified
        assert np.array_equal(g[..., y0:y1, x0:x1], r[..., y0:y1, x0:x1])


@pytest.mark.parametrize("rect", [None, (5, 3, 40, 30), (0, 0, 64, 1), (12, 7, 12, 20)])
def test_plain_k3_matches_jax_ops_everywhere(rect):
    """The whole frame, outside the rect too, equals the JAX overlay ops
    with the rect's phase anchor and focus-peaking clamps."""
    h, w, tm = 40, 64, 3.3
    p = _planes(h, w, 9)
    zb, fc, fp = tfo.fused_overlays_planes(torch.from_numpy(p), tm, rect=rect, **KW)
    jp = jnp.asarray(p)
    r = rect or (0, 0, w, h)
    tm_rect = jnp.float32(tm) - jnp.float32(r[0] + r[1])
    assert np.array_equal(zb.numpy(), np.asarray(jov.zebra_planes(jp, 0.75, 1.0, tm_rect, 2)))
    assert np.array_equal(fc.numpy(), np.asarray(jov.falsecolor_planes(jp, 1)))
    ref_fp = jov.focus_peaking_planes(jp, 3062, jnp.asarray((255, 84, 0, 255), jnp.uint8),
                                      rect=None if rect is None else jnp.asarray(rect))
    assert np.array_equal(fp.numpy(), np.asarray(ref_fp))


def test_rect_equals_the_cropped_frame():
    h, w, tm = 40, 64, 5.0
    p = _planes(h, w, 4)
    x0, y0, x1, y1 = 7, 5, 50, 33
    full = tfo.fused_overlays_planes(torch.from_numpy(p), tm, rect=(x0, y0, x1, y1), **KW)
    crop = tfo.fused_overlays_planes(
        torch.from_numpy(np.ascontiguousarray(p[:, y0:y1, x0:x1])), tm, **KW)
    for a, b in zip(full, crop):
        assert torch.equal(a[:, y0:y1, x0:x1], b)


def test_outputs_switch_and_packing():
    p = torch.from_numpy(_planes(21, 30, 2))
    all3 = tfo.fused_overlays_planes(p, 1.5, **KW)
    some = tfo.fused_overlays_planes(p, 1.5, outputs=(True, False, True), packed_out=True, **KW)
    assert some[1] is None
    assert torch.equal(some[0], tfo.packed_from_planes(all3[0]))
    assert torch.equal(some[2], tfo.packed_from_planes(all3[2]))
    # packed byte 0 is R: the low byte of the int32
    assert torch.equal((some[0] & 255).to(torch.uint8), all3[0][0])


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="device"):
        tfo.fused_overlays_planes(torch.zeros((4, 8, 8), dtype=torch.uint8, device="meta"),
                                  0.0, **KW)
