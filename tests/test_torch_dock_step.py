"""The port's make_dock_step(device="cpu") vs JAX make_dock_step on the CPU:
panel, vs_counts, wv_counts and hi_counts, exact, for the dock
configurations of this slice; and make_full_step(input_format="nv12") vs
JAX.  Each package gets its own config: the port's through
``config.from_reference``."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu import config as J
from obs_color_monitor_tpu.api import make_full_step as jax_make_full_step
from obs_color_monitor_tpu.dock_step import make_dock_step as jax_make_dock_step
from obs_color_monitor_tpu_torch import frame_from_numpy, make_dock_step, make_full_step
from obs_color_monitor_tpu_torch.config import from_reference

torch.set_num_threads(1)

H, W = 72, 128
TM = 2.5
ALL6 = J.DockConfig(show_focuspeaking=True)
LUT = np.random.default_rng(11).integers(0, 256, (40, 4), np.uint8)

CASES = {
    "default": dict(),
    "all_six": dict(dock=ALL6),
    "nv12": dict(dock=ALL6, input_format="nv12", nv12_cs=1),
    "p010_parade_stack": dict(
        dock=ALL6, input_format="nv12", nv12_shift=8,
        waveform=J.WaveformConfig(display=J.DisplayMode.PARADE, components=J.Components.YUV),
        histogram=J.HistogramConfig(display=J.DisplayMode.STACK, level_mode=J.LevelMode.RATIO,
                                    graticule_horizontal_step_ratio=2.0),
    ),
    "roi_rect_key_outside": dict(
        dock=ALL6, roi_rect=(5, 3, 50, -1),
        falsecolor=J.FalseColorConfig(show_key=J.ShowKey.OUTSIDE),
        histogram=J.HistogramConfig(components=J.Components.Y),
    ),
    "full_res_key_below_actual_size": dict(
        dock=ALL6, overlays_on_capture=False, scale=3,
        falsecolor=J.FalseColorConfig(show_key=J.ShowKey.BELOW, colorspace=1),
        focuspeaking=J.FocusPeakingConfig(actual_size=True, peaking_threshold=0.02),
    ),
    "stack_zoom_lut": dict(
        dock=J.DockConfig(show_roi=False, show_histogram=False, show_focuspeaking=True),
        waveform=J.WaveformConfig(display=J.DisplayMode.STACK),
        vectorscope=J.VectorscopeConfig(zoom=2.0, color_type=0, graticule=2),
        falsecolor=J.FalseColorConfig(use_lut=True, lut=LUT),
        zebra=J.ZebraConfig(zebra_th_low=55),
    ),
    "panel_too_short": dict(dock=ALL6, out_height=5),  # slots overlap
}


def _frames(case):
    rng = np.random.default_rng(len(case))
    if CASES[case].get("input_format") == "nv12":
        if CASES[case].get("nv12_shift"):
            y = (rng.integers(0, 1024, (H, W)) << 6).astype(np.uint16)
            uv = (rng.integers(0, 1024, (H // 2, W)) << 6).astype(np.uint16)
        else:
            y = rng.integers(0, 256, (H, W), np.uint8)
            uv = rng.integers(0, 256, (H // 2, W), np.uint8)
        return (y, uv), "nv12"
    f = rng.integers(0, 256, (H, W, 4), np.uint8)
    f[..., 3] = np.where(rng.random((H, W)) < 0.1, 0, 255)
    f[: H // 3, : W // 3, :3] = np.maximum(f[: H // 3, : W // 3, :3], 200)
    return f, "rgba"


def _port_kwargs(kw):
    return {k: from_reference(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dock_step_matches_jax(case):
    kw = dict(out_width=128, out_height=600)
    kw.update(CASES[case])
    frame, fmt = _frames(case)
    jstep = jax_make_dock_step(H, W, **kw)
    ref = jstep(frame if fmt == "rgba" else tuple(jnp.asarray(a) for a in frame),
                jnp.float32(TM))
    tstep = make_dock_step(H, W, device="cpu", **_port_kwargs(kw))
    assert tstep.rects == jstep.rects and tstep.dims == jstep.dims
    got = tstep(frame_from_numpy(frame, fmt, "cpu"), TM).to_numpy()
    for name in ("panel", "vs_counts", "wv_counts", "hi_counts"):
        a = np.asarray(getattr(ref, name))
        assert got[name].shape == a.shape and got[name].dtype == a.dtype, name
        assert np.array_equal(got[name], a), name
    assert ref.planes is None and "planes" not in got


@pytest.mark.parametrize("stackable", [True, False])
def test_compose_vstack_matches_jax(stackable):
    from obs_color_monitor_tpu.dock_step import compose_vstack as jax_compose
    from obs_color_monitor_tpu_torch.dock_step import compose_vstack

    rng = np.random.default_rng(int(stackable))
    shapes = [(0, 0, 10, 20), (5, 12, 8, 30), (0, 25, 6, 40)] if stackable else [
        (0, 0, 10, 20), (-3, 5, 8, 30), (30, 18, 9, 20)]
    patches = [(x0, y0, rng.integers(0, 256, (h, w, 4), np.uint8)) for x0, y0, h, w in shapes]
    ref = jax_compose([(x, y, jnp.asarray(p)) for x, y, p in patches], 40, 36)
    got = compose_vstack([(x, y, torch.from_numpy(p)) for x, y, p in patches], 40, 36)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_packed_rgba_frame_equals_rgba_frame():
    frame, _ = _frames("all_six")
    step = make_dock_step(H, W, dock=from_reference(ALL6), device="cpu")
    a = step(torch.from_numpy(frame), TM).to_numpy()
    b = step(torch.from_numpy(frame.view(np.uint32)[..., 0]), TM).to_numpy()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_dynamic_roi_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_dock_step(H, W, dynamic_roi=True, device="cpu")


def test_dock_step_refuses_a_frame_on_another_device_or_shape():
    step = make_dock_step(16, 32, device="cpu")
    with pytest.raises(ValueError):
        step(torch.zeros((16, 32, 4), dtype=torch.uint8, device="meta"), 0.0)
    with pytest.raises(ValueError):
        step(torch.zeros((16, 30, 4), dtype=torch.uint8), 0.0)
    with pytest.raises(ValueError):
        make_dock_step(16, 32, input_format="yuv444", device="cpu")


@pytest.mark.parametrize("shift", [0, 2])
def test_full_step_nv12_matches_jax(shift):
    h, w = 64, 96
    rng = np.random.default_rng(shift)
    if shift:
        y = rng.integers(0, 1024, (h, w)).astype(np.uint16)
        uv = rng.integers(0, 1024, (h // 2, w)).astype(np.uint16)
    else:
        y = rng.integers(0, 256, (h, w), np.uint8)
        uv = rng.integers(0, 256, (h // 2, w), np.uint8)
    ref = jax_make_full_step(h, w, scale=2, input_format="nv12", nv12_shift=shift)(
        (jnp.asarray(y), jnp.asarray(uv)), jnp.float32(TM))
    step = make_full_step(h, w, scale=2, input_format="nv12", nv12_shift=shift, device="cpu")
    got = step(frame_from_numpy((y, uv), "nv12", "cpu"), TM).to_numpy()
    for k, v in ref._asdict().items():
        v = np.asarray(v)
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("zoom", [1.0, 1.5, 3.0])
def test_blend_and_zoom_match_jax(zoom):
    from obs_color_monitor_tpu.ops import render as jr
    from obs_color_monitor_tpu_torch.ops import render as tr

    rng = np.random.default_rng(int(zoom * 10))
    img, ov = (rng.integers(0, 256, (256, 256, 4), np.uint8) for _ in range(2))
    ov[::3, :, 3] = 0
    ov[1::3, :, 3] = 255
    got = tr.blend_overlay(torch.from_numpy(img), torch.from_numpy(ov)).numpy()
    assert np.array_equal(got, np.asarray(jr.blend_overlay(jnp.asarray(img), jnp.asarray(ov))))
    p, op = (np.ascontiguousarray(np.moveaxis(a, -1, 0)) for a in (img, ov))
    got = tr.blend_overlay_planes(torch.from_numpy(p), torch.from_numpy(op)).numpy()
    ref = jr.blend_overlay_planes(jnp.asarray(p), jnp.asarray(op))
    assert np.array_equal(got, np.asarray(ref))
    got = tr.zoom_center(torch.from_numpy(img), zoom).numpy()
    assert np.array_equal(got, np.asarray(jr.zoom_center(jnp.asarray(img), zoom=zoom)))
