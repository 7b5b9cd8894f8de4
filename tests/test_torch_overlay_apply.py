"""The overlay scopes' filter flavour, ``apply(frame)``, against the JAX
package's (reference zbf_render, src/zebra.c:630-658), bit for bit on the
CPU: Zebra after ``tick()`` (its own colorspace and a given one),
FalseColor with and without a user LUT at every ``ShowKey`` placement (the
key beside the image grows the canvas), FocusPeaking at two thresholds and
two colours; on an odd shape and a second shape, the frame as a host array
and as a tensor.  Also: ``apply`` is ``apply_planes`` between planarize
and interleave, and a frame that is not (H, W, 4) u8 raises."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu import config as jcfg
from obs_color_monitor_tpu import models as jm
from obs_color_monitor_tpu_torch import models as tm
from obs_color_monitor_tpu_torch.config import from_reference
from obs_color_monitor_tpu_torch.ops.graticule import key_canvas_size

torch.set_num_threads(1)

SHAPES = [(65, 144), (48, 64)]
LUT = np.random.default_rng(17).integers(0, 256, (7, 4), np.uint8)


def _frame(h, w, seed=0):
    rng = np.random.default_rng(seed + 1000 * h + w)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
    f[: h // 3, :, :3] = np.maximum(f[: h // 3, :, :3], 200)  # zebra's window
    f[h // 2:, :, :3] = rng.integers(0, 256, (1, 1, 3), np.uint8)  # a flat region
    return f


def _pair(kind: str, cfg):
    """(the JAX scope, the port's scope on the CPU) of one config."""
    return getattr(jm, kind)(cfg), getattr(tm, kind)(from_reference(cfg), device="cpu")


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape, (tuple(got.shape), want.shape)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w", SHAPES)
def test_zebra_apply(h, w):
    f = _frame(h, w, 1)
    j, t = _pair("Zebra", jcfg.ZebraConfig(zebra_th_low=60, zebra_th_high=95))
    for _ in range(3):
        j.tick(0.25)
        t.tick(0.25)
    assert t.tm == j.tm != 0.0
    _same(t.apply(f), j.apply(jnp.asarray(f)))
    _same(t.apply(torch.from_numpy(f), cs=1), j.apply(jnp.asarray(f), cs=1))


@pytest.mark.parametrize("use_lut", [False, True])
@pytest.mark.parametrize("key", list(jcfg.ShowKey))
@pytest.mark.parametrize("h,w", SHAPES)
def test_falsecolor_apply(h, w, key, use_lut):
    f = _frame(h, w, 2)
    cfg = jcfg.FalseColorConfig(show_key=key, use_lut=use_lut, lut=LUT if use_lut else None)
    j, t = _pair("FalseColor", cfg)
    want = j.apply(jnp.asarray(f))
    got = t.apply(f)
    _same(got, want)
    assert tuple(got.shape[:2]) == key_canvas_size(t.config.show_key, w, h)[::-1]
    _same(t.apply(torch.from_numpy(f), cs=2), j.apply(jnp.asarray(f), cs=2))


@pytest.mark.parametrize("threshold,color", [(0.05, 0xFFFF5400), (0.012, 0xFF00FF20)])
@pytest.mark.parametrize("h,w", SHAPES)
def test_focuspeaking_apply(h, w, threshold, color):
    f = _frame(h, w, 3)
    f[::5, :, :3] = 255  # edges at every threshold
    j, t = _pair("FocusPeaking", jcfg.FocusPeakingConfig(peaking_threshold=threshold,
                                                         peaking_color=color))
    want = j.apply(jnp.asarray(f))
    assert (np.asarray(want) != f).any()
    _same(t.apply(f), want)
    _same(t.apply(torch.from_numpy(f)), want)


def test_apply_is_apply_planes_interleaved():
    f = _frame(33, 40, 4)
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0)))
    for scope in (tm.Zebra(device="cpu"), tm.FocusPeaking(device="cpu"),
                  tm.FalseColor(from_reference(jcfg.FalseColorConfig(
                      show_key=jcfg.ShowKey.BELOW)), device="cpu")):
        assert torch.equal(scope.apply(f), scope.apply_planes(planes).permute(1, 2, 0))
        for bad in (f[..., :3], f.astype(np.int32), f[None]):
            with pytest.raises(ValueError):
                scope.apply(bad)
