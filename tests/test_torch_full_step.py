"""Port make_full_step(device="cpu") vs JAX make_full_step on the CPU: all
nine ScopeOutputs fields, exact, and the counts vs the golden model."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.api import make_full_step as jax_make_full_step
from obs_color_monitor_tpu.colorspace import Colorspace
from obs_color_monitor_tpu.config import (
    Components,
    DisplayMode,
    FalseColorConfig,
    HistogramConfig,
    LevelMode,
    WaveformConfig,
)
from obs_color_monitor_tpu_torch import frame_from_numpy, make_full_step

torch.set_num_threads(1)

TM = 2.5


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
    f[: h // 4, : w // 3, :3] = np.maximum(f[: h // 4, : w // 3, :3], 200)  # zebra window
    return f


def _as_format(f, fmt):
    if fmt == "packed":
        return f.view(np.uint32).reshape(f.shape[:2])
    if fmt == "planar":
        return np.ascontiguousarray(np.moveaxis(f, -1, 0))
    return f


def _configs():
    lut = np.random.default_rng(1).integers(0, 256, (64, 4), np.uint8)
    return {
        "rgb_s2": dict(h=131, w=270, kw=dict(scale=2)),
        "yuv_s8": dict(
            h=140, w=270,
            kw=dict(
                scale=8,
                waveform=WaveformConfig(components=Components.YUV, display=DisplayMode.PARADE),
                histogram=HistogramConfig(components=Components.YUV, display=DisplayMode.STACK,
                                          logscale=False, level_mode=LevelMode.RATIO),
            ),
        ),
        "mixed_lut_s3": dict(
            h=64, w=96,
            kw=dict(
                scale=3,
                cs=Colorspace.BT601,
                waveform=WaveformConfig(components=Components.RGB, display=DisplayMode.STACK),
                histogram=HistogramConfig(components=Components.UV, display=DisplayMode.PARADE,
                                          level_mode=LevelMode.PIXEL),
                falsecolor=FalseColorConfig(use_lut=True, lut=lut),
            ),
        ),
    }


_JAX_CACHE = {}


def _jax_outputs(name):
    """One JAX compile and run per configuration, shared by its cases."""
    if name not in _JAX_CACHE:
        c = _configs()[name]
        f = _frame(c["h"], c["w"], c["h"] * c["w"])
        step = jax_make_full_step(c["h"], c["w"], **c["kw"])
        out = step(jnp.asarray(f), jnp.float32(TM))
        _JAX_CACHE[name] = (f, {k: np.asarray(v) for k, v in out._asdict().items()})
    return _JAX_CACHE[name]


def _check_golden(f, c, got):
    kw = c["kw"]
    cs = int(kw.get("cs", Colorspace.BT709))
    ds = golden.downscale(f, kw["scale"])
    yuv = golden.rgb_to_yuv_u8(ds, cs)
    wv_c = kw.get("waveform", WaveformConfig()).components
    hi_c = kw.get("histogram", HistogramConfig()).components
    assert np.array_equal(got["vs_counts"], golden.vectorscope_counts(yuv))
    assert np.array_equal(got["wv_counts"], golden.waveform_counts(ds, yuv, wv_c))
    assert np.array_equal(got["hi_counts"], golden.histogram_counts(ds, yuv, hi_c))


@pytest.mark.parametrize(
    "name,fmt",
    [
        ("rgb_s2", "rgba"),
        ("rgb_s2", "packed"),
        ("rgb_s2", "planar"),
        ("yuv_s8", "packed"),
        ("mixed_lut_s3", "rgba"),
    ],
)
def test_full_step_matches_jax_and_golden(name, fmt):
    f, ref = _jax_outputs(name)
    c = _configs()[name]
    step = make_full_step(c["h"], c["w"], input_format=fmt, device="cpu", **c["kw"])
    got = step(frame_from_numpy(_as_format(f, fmt), fmt, "cpu"), TM).to_numpy()
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k
    _check_golden(f, c, got)


def test_nv12_names_the_roadmap_item():
    # NV12 input, once a ROADMAP item, is ported: the step now refuses only
    # planes whose depth does not match nv12_shift, as the JAX step does
    y8, uv8 = torch.zeros((64, 64), dtype=torch.uint8), torch.zeros((32, 64), dtype=torch.uint8)
    y16, uv16 = y8.to(torch.uint16), uv8.to(torch.uint16)
    nv12 = make_full_step(64, 64, input_format="nv12", device="cpu")
    p010 = make_full_step(64, 64, input_format="nv12", nv12_shift=8, device="cpu")
    with pytest.raises(TypeError):
        nv12((y16, uv16), 0.0)
    with pytest.raises(TypeError):
        p010((y8, uv8), 0.0)


def test_step_refuses_a_frame_on_another_device_or_shape():
    step = make_full_step(16, 16, input_format="planar", device="cpu")
    with pytest.raises(ValueError):
        step(torch.zeros((4, 16, 16), dtype=torch.uint8, device="meta"), 0.0)
    with pytest.raises(ValueError):
        step(torch.zeros((4, 16, 17), dtype=torch.uint8), 0.0)
