"""The port's frame_pipeline on the CPU (the kernels' plain versions) vs JAX
frame_pipeline in Pallas interpret mode (as tests/test_pipeline_kernel.py
runs it), all six outputs, exact; and vs golden at a scale the TPU kernel
does not take."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.config import Components
from obs_color_monitor_tpu.golden.reference import peaking_threshold_fixed
from obs_color_monitor_tpu.ops.pallas_pipeline import frame_pipeline as jax_frame_pipeline
from obs_color_monitor_tpu_torch.ops import pipeline as tp
from obs_color_monitor_tpu_torch.ops.scope_stats import vs_wv_counts

torch.set_num_threads(1)

ARGS = dict(
    th_low=0.75, th_high=1.0, zb_cs=2, fc_cs=1,
    peak_th=3062, peak_rgba=(255, 84, 0, 255),
)
NAMES = ["vs", "wv", "ds", "zb", "fc", "fp"]


def _planes(h4, w4, seed):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (4, h4, w4), np.uint8)
    p[3] = np.where(rng.random((h4, w4)) < 0.2, 0, p[3])  # alpha-0 pixels
    return p


def _packed(p):
    return np.ascontiguousarray(np.moveaxis(p, 0, -1)).view(np.int32)[..., 0]


@pytest.mark.parametrize(
    "h4,w4,scale,yuv_data",
    [(129, 131, 2, True), (13, 17, 2, False), (140, 270, 8, False)],
)
def test_pipeline_matches_jax_interpret(h4, w4, scale, yuv_data):
    p = _planes(h4, w4, h4 * w4 + scale)
    ref = jax_frame_pipeline(
        jnp.asarray(p), jnp.float32(2.5), cs=2, scale=scale, yuv_data=yuv_data,
        interpret=True, **ARGS,
    )
    for packed in (False, True):
        x = torch.from_numpy(_packed(p) if packed else p)
        got = tp.frame_pipeline(x, 2.5, cs=2, scale=scale, yuv_data=yuv_data,
                                packed=packed, **ARGS)
        for name, a, b in zip(NAMES, got, ref):
            assert np.array_equal(a.numpy(), np.asarray(b)), (name, packed)


def test_pipeline_packed_jax_input():
    """The JAX packed route (u32 view) gives what the port's int32 view gives."""
    p = _planes(13, 17, 4)
    x32 = jax.lax.bitcast_convert_type(jnp.asarray(np.moveaxis(p, 0, -1).copy()), jnp.uint32)
    ref = jax_frame_pipeline(x32, jnp.float32(1.5), cs=1, scale=2, packed=True,
                             interpret=True, **ARGS)
    got = tp.frame_pipeline(torch.from_numpy(_packed(p)), 1.5, cs=1, scale=2, packed=True, **ARGS)
    for name, a, b in zip(NAMES, got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b)), name


def test_no_overlays_mode():
    p = torch.from_numpy(_planes(33, 45, 9))
    full = tp.frame_pipeline(p, 1.0, cs=1, scale=2, **ARGS)
    got = tp.frame_pipeline(p, 1.0, cs=1, scale=2, with_overlays=False, **ARGS)
    assert got[3:] == (None, None, None)
    for name, a, b in zip(NAMES[:3], got, full):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("scale,yuv_data", [(3, False), (5, True), (1, False)])
def test_pipeline_any_scale_vs_golden(scale, yuv_data):
    """Scales outside the TPU kernel's 1/2/4/8 against the golden model."""
    p = _planes(65, 144, scale)
    f = np.ascontiguousarray(np.moveaxis(p, 0, -1))
    args = dict(ARGS, peak_th=peaking_threshold_fixed(0.05))
    vs, wv, ds, zb, fc, fp = tp.frame_pipeline(
        torch.from_numpy(p), 0.5, cs=1, scale=scale, yuv_data=yuv_data, **args
    )
    gds = golden.downscale(f, scale)
    gyuv = golden.rgb_to_yuv_u8(gds, 1)
    comps = Components.YUV if yuv_data else Components.RGB
    assert np.array_equal(np.moveaxis(ds.numpy(), 0, -1), gds)
    assert np.array_equal(vs.clamp(max=255).numpy(), golden.vectorscope_counts(gyuv))
    assert np.array_equal(wv.clamp(max=255).numpy(), golden.waveform_counts(gds, gyuv, comps))
    assert np.array_equal(np.moveaxis(zb.numpy(), 0, -1), golden.zebra(f, 0.75, 1.0, 0.5, 2))
    assert np.array_equal(np.moveaxis(fc.numpy(), 0, -1), golden.falsecolor(f, 1))
    rgba = tuple(c / 255 for c in ARGS["peak_rgba"])
    assert np.array_equal(np.moveaxis(fp.numpy(), 0, -1), golden.focus_peaking(f, 0.05, rgba))


def test_reference_equals_wrapper_on_cpu():
    p = torch.from_numpy(_planes(20, 30, 1))
    a = tp.frame_pipeline(p, 3.0, cs=2, scale=2, **ARGS)
    b = tp.frame_pipeline_reference(p, 3.0, cs=2, scale=2, **ARGS)
    for name, x, y in zip(NAMES, a, b):
        assert torch.equal(x, y), name


def test_wrappers_refuse_other_devices():
    """A tensor that is neither CPU nor CUDA raises; nothing falls back."""
    meta = torch.empty((4, 16, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        tp.frame_pass(meta, 0.0, packed=False, cs=2, scale=2)
    plane = torch.empty((8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        vs_wv_counts(plane, plane, torch.empty((3, 8, 8), dtype=torch.uint8, device="meta"), None)
