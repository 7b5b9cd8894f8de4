"""The dynamic ROI in the port, on the CPU: K2's and K3's plain versions
with a rect tensor, ``analyze(rect_dyn=)`` and
``make_dock_step(dynamic_roi=True)``, against JAX (``analyze(rect_dyn=)``,
``fused_overlays_planes(rect=, interpret=True)``, the dynamic dock step)
and against the port's own static crop and ``roi_rect`` step, exact.  Also:
the argument checks, and that every rect runs the same operations with the
same shapes and reads nothing back to the host."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from obs_color_monitor_tpu import config as J
from obs_color_monitor_tpu.dock_step import make_dock_step as jax_make_dock_step
from obs_color_monitor_tpu.ops.fused import analyze as jax_analyze
from obs_color_monitor_tpu.ops.pallas_overlays import fused_overlays_planes as jax_fused
from obs_color_monitor_tpu_torch import frame_from_numpy, make_dock_step
from obs_color_monitor_tpu_torch.config import from_reference
from obs_color_monitor_tpu_torch.ops import fused as tfused
from obs_color_monitor_tpu_torch.ops import fused_overlays as tfo
from obs_color_monitor_tpu_torch.ops import pipeline as tp
from obs_color_monitor_tpu_torch.ops import scope_stats as ss
from obs_color_monitor_tpu_torch.ops.stats import saturate_u8

torch.set_num_threads(1)

H, W = 120, 160  # the frame of tests/test_dynamic_roi.py; 80x60 scaled
# JAX's RECTS (tests/test_dynamic_roi.py:28), then a negative, an
# oversized, an empty, a reversed and a one-pixel rect
RECTS = [(10, 8, 50, 40), (0, 0, 80, 60), (5, 5, 75, 55), (79, 59, 80, 60),
         (-7, -3, 30, 20), (40, 30, 500, 300), (30, 30, 30, 40), (50, 10, -3, 50),
         (12, 13, 13, 14)]
OV = dict(th_low=0.6, th_high=0.95, zb_cs=2, fc_cs=1, peak_th=2000, peak_rgba=(255, 0, 0, 255))


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(7)
    f = rng.integers(0, 256, (H, W, 4), np.uint8)
    f[rng.random((H, W)) < 0.08, 3] = 0  # alpha-skipped pixels
    return f


def _rect(r):
    return torch.tensor(r, dtype=torch.int32)


def _clip(r, w, h):
    x0, y0 = min(max(r[0], 0), w), min(max(r[1], 0), h)
    return x0, y0, min(max(r[2], x0), w), min(max(r[3], y0), h)


@pytest.mark.parametrize("yuv", [False, True])
def test_k2_rect_matches_jax_analyze(frame, yuv):
    planes = np.ascontiguousarray(np.moveaxis(frame, -1, 0))
    ds, yuv_p, *_ = tp.frame_pass_reference(torch.from_numpy(planes), packed=False, cs=2,
                                            scale=2, with_overlays=False)
    kw = dict(cs=2, scale=2, need_vs=True, need_wv_rgb=not yuv, need_wv_yuv=yuv,
              need_hi_rgb=not yuv, need_hi_yuv=yuv, is_planar=True)
    for r in RECTS:
        ref = jax_analyze(jnp.asarray(planes), rect_dyn=jnp.asarray(r, jnp.int32),
                          backend="xla", **kw)
        vs, wv = ss.vs_wv_counts(*tp.stats_inputs(ds, yuv_p, yuv), rect=_rect(r))
        assert np.array_equal(saturate_u8(vs).numpy(), np.asarray(ref.vs_counts)), r
        assert np.array_equal(saturate_u8(wv).numpy(),
                              np.asarray(ref.wv_yuv if yuv else ref.wv_rgb)), r
        hi = ss.histogram_from_waveform(wv).numpy()
        assert np.array_equal(hi, np.asarray(ref.hi_yuv if yuv else ref.hi_rgb)), r
        # each mode alone gives the same counts
        alone_vs, _ = ss.vs_wv_counts(yuv_p[1], yuv_p[2], None, None, need_wv=False,
                                      rect=_rect(r))
        _, alone_wv = ss.vs_wv_counts(*tp.stats_inputs(ds, yuv_p, yuv), need_vs=False,
                                      rect=_rect(r))
        assert torch.equal(alone_vs, vs) and torch.equal(alone_wv, wv)


@pytest.mark.parametrize("yuv", [False, True])
@pytest.mark.parametrize("fmt", ["rgba", "planar"])
def test_analyze_rect_dyn_matches_static_crop_and_jax(frame, yuv, fmt):
    x = frame if fmt == "rgba" else np.ascontiguousarray(np.moveaxis(frame, -1, 0))
    kw = dict(cs=2, scale=2, need_vs=True, need_wv_rgb=not yuv, need_wv_yuv=yuv,
              need_hi_rgb=not yuv, need_hi_yuv=yuv, is_planar=fmt == "planar")
    for r in RECTS:
        d = tfused.analyze(torch.from_numpy(x), rect_dyn=_rect(r), **kw)
        ref = jax_analyze(jnp.asarray(x), rect_dyn=jnp.asarray(r, jnp.int32), backend="xla",
                          **kw)
        for name in ("vs_counts", "wv_rgb", "wv_yuv", "hi_rgb", "hi_yuv", "planes",
                     "yuv_planes"):
            a, b = getattr(d, name), getattr(ref, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert np.array_equal(a.numpy().astype(np.int64),
                                      np.asarray(b).astype(np.int64)), (r, name)
        c = _clip(r, 80, 60)
        if c[0] < c[2] and c[1] < c[3]:
            s = tfused.analyze(torch.from_numpy(x), rect=c, **kw)
            wv_d, wv_s = (d.wv_yuv, s.wv_yuv) if yuv else (d.wv_rgb, s.wv_rgb)
            assert torch.equal(d.vs_counts, s.vs_counts), r
            assert torch.equal(wv_d[:, :, c[0]:c[2]], wv_s), r
            assert not wv_d[:, :, : c[0]].any() and not wv_d[:, :, c[2]:].any()
            assert torch.equal(d.hi_yuv if yuv else d.hi_rgb, s.hi_yuv if yuv else s.hi_rgb)
        else:  # an empty rect counts nothing
            assert not d.vs_counts.any() and not (d.wv_yuv if yuv else d.wv_rgb).any()


@pytest.mark.parametrize("packed_out", [False, True])
def test_k3_rect_tensor_matches_pallas_in_rect(frame, packed_out):
    planes = np.ascontiguousarray(np.moveaxis(frame, -1, 0))
    tm = 3.7
    for r in [(15, 7, 150, 100), (0, 0, 160, 120), (100, 80, 160, 120), (-4, 5, 40, 400)]:
        got = tfo.fused_overlays_planes(torch.from_numpy(planes), tm, rect=_rect(r),
                                        packed_out=packed_out, **OV)
        ref = jax_fused(jnp.asarray(planes), jnp.float32(tm), rect=jnp.asarray(r, jnp.int32),
                        packed_out=packed_out, interpret=True, **OV)
        x0, y0, x1, y1 = _clip(r, W, H)
        for g, e in zip(got, ref):
            g = g.numpy().view(np.uint32) if packed_out else g.numpy()
            # JAX leaves the pixels outside the rect unspecified
            assert np.array_equal(g[..., y0:y1, x0:x1], np.asarray(e)[..., y0:y1, x0:x1]), r


def test_k3_rect_tensor_equals_host_rect(frame):
    """A rect tensor and the same rect as host integers give the same
    overlays over the whole frame, for every rect including the clamped,
    empty and reversed ones."""
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frame, -1, 0)))
    for r in RECTS:
        a = tfo.fused_overlays_planes(planes, 1.25, rect=_rect(r), **OV)
        b = tfo.fused_overlays_planes(planes, 1.25, rect=r, **OV)
        for x, y in zip(a, b):
            assert torch.equal(x, y), r


def _port_kw(kw):
    return {k: from_reference(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}


# the histogram in PIXEL level mode: JAX's XLA CPU render of the fill test
# leaves an exact tie (level == threshold * hi_max) unfilled where golden
# and the port fill it (test_histogram_tie_follows_golden), so AUTO levels
# would compare the two renders only away from ties
DOCKS = {
    "rgba": dict(dock=J.DockConfig(show_focuspeaking=True),
                 histogram=J.HistogramConfig(level_mode=J.LevelMode.PIXEL)),
    "nv12_parade_key": dict(
        dock=J.DockConfig(show_focuspeaking=True), input_format="nv12", nv12_cs=1,
        waveform=J.WaveformConfig(display=J.DisplayMode.PARADE),
        histogram=J.HistogramConfig(level_mode=J.LevelMode.PIXEL, display=J.DisplayMode.STACK),
        falsecolor=J.FalseColorConfig(show_key=J.ShowKey.OUTSIDE)),
    "lut_below_actual_size": dict(
        dock=J.DockConfig(show_focuspeaking=True),
        histogram=J.HistogramConfig(level_mode=J.LevelMode.PIXEL, components=J.Components.YUV),
        falsecolor=J.FalseColorConfig(
            show_key=J.ShowKey.BELOW, use_lut=True,
            lut=np.random.default_rng(3).integers(0, 256, (40, 4), np.uint8)),
        focuspeaking=J.FocusPeakingConfig(actual_size=True)),
}


def _dock_input(case, frame):
    if DOCKS[case].get("input_format") == "nv12":
        rng = np.random.default_rng(11)
        y = rng.integers(0, 256, (H, W), np.uint8)
        uv = rng.integers(0, 256, (H // 2, W), np.uint8)
        return (y, uv), "nv12", (jnp.asarray(y), jnp.asarray(uv))
    return frame, "rgba", frame


@pytest.mark.parametrize("case", sorted(DOCKS))
def test_dynamic_dock_step_matches_jax(frame, case):
    kw = dict(scale=2, out_width=128, out_height=784, **DOCKS[case])
    jstep = jax_make_dock_step(H, W, dynamic_roi=True, **kw)
    tstep = make_dock_step(H, W, dynamic_roi=True, device="cpu", **_port_kw(kw))
    assert tstep.rects == jstep.rects and tstep.dims == jstep.dims
    x, fmt, jx = _dock_input(case, frame)
    tx = frame_from_numpy(x, fmt, "cpu")
    for i, r in enumerate(RECTS):
        tm = 0.75 * i
        ref = jstep(jx, np.float32(tm), jnp.asarray(r, jnp.int32))
        got = tstep(tx, tm, _rect(r)).to_numpy()
        for name in ("panel", "vs_counts", "wv_counts", "hi_counts", "planes"):
            a = np.asarray(getattr(ref, name))
            assert got[name].shape == a.shape and got[name].dtype == a.dtype, (r, name)
            assert np.array_equal(got[name], a), (r, name)


@pytest.mark.parametrize("fmt", ["rgba", "nv12"])
def test_dynamic_dock_step_matches_static_roi_rect(frame, fmt):
    """At a rect inside the capture, the statistics and every band but the
    ROI preview equal the static roi_rect step's (AUTO and RATIO levels:
    the rect's pixel count is a device tensor in the dynamic step)."""
    dk = J.DockConfig(show_focuspeaking=True)
    kw = dict(scale=2, out_width=128, out_height=784, dock=from_reference(dk), device="cpu")
    if fmt == "nv12":
        kw["histogram"] = from_reference(J.HistogramConfig(level_mode=J.LevelMode.RATIO))
    x, fmt, _ = _dock_input("nv12_parade_key" if fmt == "nv12" else "rgba", frame)
    if fmt == "nv12":
        kw["input_format"] = "nv12"
    tx = frame_from_numpy(x, fmt, "cpu")
    dyn = make_dock_step(H, W, dynamic_roi=True, **kw)
    band = dyn.rects["vectorscope"][1]  # the first row below the ROI preview's slot
    for r in RECTS[:4]:
        out_d = dyn(tx, 2.5, _rect(r)).to_numpy()
        out_s = make_dock_step(H, W, roi_rect=r, **kw)(tx, 2.5).to_numpy()
        assert np.array_equal(out_d["vs_counts"], out_s["vs_counts"]), r
        assert np.array_equal(out_d["hi_counts"], out_s["hi_counts"]), r
        assert np.array_equal(out_d["wv_counts"][:, :, r[0]:r[2]], out_s["wv_counts"]), r
        assert np.array_equal(out_d["panel"][band:], out_s["panel"][band:]), r


def test_two_clamping_rules(frame):
    """The static roi_rect reads a negative x1 as the full width; the
    dynamic rect clips it, which empties the rect."""
    kw = dict(scale=2, out_width=128, out_height=784, device="cpu")
    tx = torch.from_numpy(frame)
    st = make_dock_step(H, W, roi_rect=(10, 8, -1, 40), **kw)(tx, 1.0).to_numpy()
    full = make_dock_step(H, W, roi_rect=(10, 8, 80, 40), **kw)(tx, 1.0).to_numpy()
    assert np.array_equal(st["vs_counts"], full["vs_counts"])
    dyn = make_dock_step(H, W, dynamic_roi=True, **kw)(tx, 1.0, _rect((10, 8, -1, 40)))
    assert not dyn.vs_counts.any() and not dyn.wv_counts.any() and not dyn.hi_counts.any()


def test_argument_checks():
    with pytest.raises(ValueError):
        make_dock_step(H, W, roi_rect=(0, 0, 10, 10), dynamic_roi=True, device="cpu")
    with pytest.raises(NotImplementedError):
        make_dock_step(H, W, dynamic_roi=True, overlays_on_capture=False, device="cpu")
    step = make_dock_step(H, W, dynamic_roi=True, device="cpu")
    f = torch.zeros((H, W, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        step(f, 0.0, torch.tensor([0, 0, 4, 4], dtype=torch.int64))
    with pytest.raises(ValueError):
        step(f, 0.0, torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        ss.vs_wv_counts(torch.zeros((4, 4), dtype=torch.uint8, device="meta"),
                        torch.zeros((4, 4), dtype=torch.uint8, device="meta"), None, None,
                        need_wv=False, rect=_rect((0, 0, 1, 1)))
    for sk in (J.ShowKey.LEFT, J.ShowKey.OUTSIDE, J.ShowKey.BELOW):
        dk = make_dock_step(H, W, dynamic_roi=True, device="cpu",
                            falsecolor=from_reference(J.FalseColorConfig(show_key=sk)))
        assert dk.dims["falsecolor"] == (0, 0)


class _OpLog(TorchDispatchMode):
    """Every operation a step dispatches, with its output shapes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = tuple(tuple(o.shape) for o in (out if isinstance(out, (tuple, list)) else [out])
                       if isinstance(o, torch.Tensor))
        self.ops.append((str(func), shapes))
        return out


@pytest.mark.parametrize("fmt", ["rgba", "nv12"])
def test_every_rect_runs_the_same_operations(frame, fmt):
    """A new rect changes no operation, no shape and reads nothing back to
    the host (no ``_local_scalar_dense``, the op behind ``.item()``): the
    CPU counterpart of the launch counts and of the CUDA-graph replay."""
    x, fmt, _ = _dock_input("nv12_parade_key" if fmt == "nv12" else "rgba", frame)
    kw = dict(scale=2, out_width=128, out_height=784, device="cpu", input_format=fmt,
              dock=from_reference(J.DockConfig(show_focuspeaking=True)),
              falsecolor=from_reference(J.FalseColorConfig(show_key=J.ShowKey.OUTSIDE)))
    step = make_dock_step(H, W, dynamic_roi=True, **kw)
    tx = frame_from_numpy(x, fmt, "cpu")
    logs = []
    # the first call also builds the index tensors cached for later calls
    # (zoom and slot indices), so the rects are compared from the second on
    for r in RECTS[-1:] + RECTS:
        rect = _rect(r)
        with _OpLog() as log:
            step(tx, 1.0, rect)
        logs.append(log.ops)
    assert all(ops == logs[1] for ops in logs[2:])
    assert not any("_local_scalar_dense" in op for ops in logs for op, _ in ops)


def test_histogram_tie_follows_golden():
    """At an exact tie of the histogram's fill test, level == (1 - (row +
    0.5) / H) * hi_max (here 15 == 0.3125 * 48 at row 137 of 200), the port
    fills the pixel, as the golden model does; JAX's render on the CPU
    leaves it empty, so the dock comparisons with JAX above use levels that
    cannot tie."""
    from obs_color_monitor_tpu_torch.golden import render as golden_render
    from obs_color_monitor_tpu_torch.ops import render as tr

    lv = np.zeros((3, 256), np.float32)
    lv[:, 0] = 15.0
    hm = np.full(3, 48.0, np.float32)
    got = tr.render_histogram(torch.from_numpy(lv), torch.from_numpy(hm), 200, 0, 3,
                              False).numpy()
    want = golden_render.render_histogram(lv, hm, 200, 0, 3, False)
    assert np.array_equal(got, want)
    assert (got[137, 0, :3] == 255).all()
