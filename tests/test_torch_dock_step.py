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


# source dims (w, h) of each scope in a few typical configurations: a 4K
# capture at scale 2, a portrait capture with a parade waveform and the
# key legend OUTSIDE, and the dynamic step's (overlay slots of no size)
LAYOUT_DIMS = {
    "uhd_capture": dict(roi=(1920, 1080), vectorscope=(256, 256), waveform=(1920, 256),
                        histogram=(256, 200), zebra=(1920, 1080), falsecolor=(1920, 1080),
                        focuspeaking=(1920, 1080)),
    "portrait_parade_key": dict(roi=(720, 1280), vectorscope=(256, 256), waveform=(2160, 256),
                                histogram=(768, 600), zebra=(720, 1280), falsecolor=(792, 1280),
                                focuspeaking=(720, 1280)),
    "dynamic": dict(roi=(1280, 720), vectorscope=(256, 256), waveform=(1280, 768),
                    histogram=(256, 200), zebra=(0, 0), falsecolor=(0, 0), focuspeaking=(0, 0)),
}


@pytest.mark.parametrize("panel", [(512, 1536), (64, 5)])  # the second too short: slots overlap
@pytest.mark.parametrize("fp_actual", [False, True])
@pytest.mark.parametrize("dims", sorted(LAYOUT_DIMS))
def test_panel_layout_matches_jax(dims, fp_actual, panel):
    """``ops/compose.panel_layout`` over every shown subset: its fitted
    boxes, each at least one pixel, are the JAX ``dock_step._layout``'s
    rects, and so are the port's ``dock_step._layout``; each box is drawn
    as fitted but focus peaking's at actual size, the source's centred 1:1
    window inside its band."""
    from obs_color_monitor_tpu.dock_step import _layout as jax_layout
    from obs_color_monitor_tpu_torch import dock_step
    from obs_color_monitor_tpu_torch.ops import compose

    cx, cy = panel
    for mask in range(1, 1 << len(dock_step.SCOPE_ORDER)):
        shown = [(n, *LAYOUT_DIMS[dims][n]) for i, n in enumerate(dock_step.SCOPE_ORDER)
                 if mask >> i & 1]
        want = jax_layout(shown, cx, cy, fp_actual)
        boxes = compose.panel_layout(shown, cx, cy, fp_actual)
        assert {n: (f.x0, f.y0, max(f.w, 1), max(f.h, 1))
                for n, (f, _) in boxes.items()} == want, shown
        assert dock_step._layout(shown, cx, cy, fp_actual) == want
        for (n, w_src, h_src), (f, b) in zip(shown, boxes.values()):
            if n == "focuspeaking" and fp_actual:
                w, h = min(f.w, w_src), min(f.h, h_src)
                assert b == ((cx - w) // 2, f.y0, w, h, ((w_src - w) // 2, (h_src - h) // 2))
            else:
                assert b == f and b.crop is None


DOCK_CASES = {
    "default": dict(),
    "all_six": dict(config=ALL6),
    "actual_size_key_below": dict(config=ALL6,
                                  falsecolor=J.FalseColorConfig(show_key=J.ShowKey.BELOW),
                                  focuspeaking=J.FocusPeakingConfig(actual_size=True)),
    "hidden_stack": dict(config=J.DockConfig(show_roi=False, show_histogram=False),
                         waveform=J.WaveformConfig(display=J.DisplayMode.STACK)),
}


@pytest.mark.parametrize("case", sorted(DOCK_CASES))
def test_dock_panel_equals_the_static_step(case):
    """A CPU Dock at the full rect lays out and assembles its panel as the
    static ``make_dock_step`` does (``Dock.render_device``): on a settled
    frame and on the eager composite its panel is the step's, and its
    ``_rects`` are the step's rects and dims; focus peaking's at actual
    size is the window drawn inside the step's band."""
    from obs_color_monitor_tpu_torch.config import ROIConfig
    from obs_color_monitor_tpu_torch.models import Dock

    dock = Dock(roi=ROIConfig(interleave=0, target_scale=2), device="cpu",
                **_port_kwargs(DOCK_CASES[case]))
    frame, _ = _frames("all_six")
    cx, cy = 200, 900
    for _ in range(3):
        dock.push_frame(frame)
        settled = dock.render_async(cx, cy).numpy()
    rects = dict(dock._rects)
    eager = dock.render_async(cx, cy).numpy()
    assert dock._rects == rects
    want = dock.render_device(frame, 0.0, cx, cy)
    assert np.array_equal(settled, want) and np.array_equal(eager, want)
    step = dock._device_step
    assert not hasattr(step, "table") and list(rects) == list(step.rects)
    for n, (x0, y0, w, h, w_src, h_src) in rects.items():
        assert (w_src, h_src) == step.dims[n], n
        bx, by, bw, bh = step.rects[n]
        if n == "focuspeaking" and dock.focuspeaking.config.actual_size:
            assert (x0, y0, w, h) == ((cx - min(bw, w_src)) // 2, by, min(bw, w_src),
                                      min(bh, h_src))
        else:
            assert (x0, y0, w, h) == (bx, by, bw, bh), n


def test_packed_rgba_frame_equals_rgba_frame():
    frame, _ = _frames("all_six")
    step = make_dock_step(H, W, dock=from_reference(ALL6), device="cpu")
    a = step(torch.from_numpy(frame), TM).to_numpy()
    b = step(torch.from_numpy(frame.view(np.uint32)[..., 0]), TM).to_numpy()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_dynamic_roi_names_the_roadmap_item():
    # The name dates from when the dynamic ROI was refused with its ROADMAP
    # item; it no longer describes the test.  The test now checks that
    # dynamic_roi=True builds a (frame, tm, rect) step and keeps JAX's
    # argument checks (tests/test_torch_dynamic_roi.py covers the step).
    step = make_dock_step(H, W, dynamic_roi=True, device="cpu")
    assert step.dims["zebra"] == (0, 0)
    with pytest.raises(ValueError):
        make_dock_step(H, W, dynamic_roi=True, roi_rect=(0, 0, 10, 10), device="cpu")
    with pytest.raises(NotImplementedError):
        make_dock_step(H, W, dynamic_roi=True, overlays_on_capture=False, device="cpu")


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


# The settled route's host work, on the CPU: the benchmark's three
# settled-route docks at an eighth of their frame size -> (frame (h, w), the
# dock's keywords, roi.interleave)
SETTLED_ROUTES = {
    "uhd_eighth": ((270, 480), dict(show_focuspeaking=True), 0),
    "desktop_eighth": ((180, 320), dict(), 0),
    "uhd_eighth_interleave1": ((270, 480), dict(show_focuspeaking=True), 1),
}


@pytest.mark.parametrize("route", sorted(SETTLED_ROUTES))
def test_settled_route_builds_each_table_once(route, monkeypatch):
    """A streaming Dock through 30 settled frames (and at interleave 1 the
    30 skipped frames between them): the settled step's key does not change
    after the first settled frame, the panel's slot table is built once per
    layout (none after the first settled or skipped frame), and the
    tracked objects do not grow from frame to frame."""
    import gc

    from obs_color_monitor_tpu_torch.config import DockConfig, ROIConfig
    from obs_color_monitor_tpu_torch.models import Dock
    from obs_color_monitor_tpu_torch.ops import compose

    (h, w), show, interleave = SETTLED_ROUTES[route]
    dock = Dock(DockConfig(width=512, height=1536, **show),
                roi=ROIConfig(interleave=interleave, target_scale=2), device="cpu")
    table = compose.static_table
    table.cache_clear()
    layouts = set()

    def spy(layout, out):
        layouts.add(layout)
        return table(layout, out)

    monkeypatch.setattr(compose, "static_table", spy)
    rng = np.random.default_rng(len(route))
    planes = [rng.integers(0, 256, (h * 3 // 2, w), np.uint8) for _ in range(3)]
    keys, misses, routes, tracked = [], [], [], {}
    hub = dock.hub
    for i in range(4 + 30 * (1 + interleave)):
        if i in (12, 4 + 30 * (1 + interleave) - 1):
            gc.collect()
            tracked[i] = len(gc.get_objects())
        done = (hub.frames_processed, hub.frames_skipped)
        b = planes[i % 3]
        dock.push_nv12(b[:h], b[h:])
        dock.render_async()
        keys.append(dock._settled_key)
        misses.append(table.cache_info().misses)
        routes.append("skipped" if hub.frames_skipped > done[1] else
                      "settled" if keys[-1] is not None and hub.frames_processed > done[0]
                      else "fanout")
    first = keys.index(next(k for k in keys if k is not None))
    assert first <= 3 and all(k == keys[first] for k in keys[first:])
    assert routes[first:].count("settled") >= 30 and "fanout" not in routes[first + 1:]
    assert routes[first:] == ["settled", "skipped"][:1 + interleave] * (
        (len(routes) - first) // (1 + interleave)), routes
    assert table.cache_info().misses == len(layouts)
    assert misses[-1] == misses[first + interleave]
    (a, n_a), (b, n_b) = sorted(tracked.items())
    assert n_b - n_a < b - a, tracked
