"""The port's model layer (``obs_color_monitor_tpu_torch.models``) against
the JAX package's on the CPU: the same frames and mouse events go to a JAX
``Dock`` and a port ``Dock``, and every panel and every published statistic
must be equal, exact.  One JAX Dock serves the whole module (its programs
compile once): a scripted session walks push/render alternation, pushes
without a render, flush, a live move-drag, NV12 and P010 pushes,
interleave and bypass, and each test checks its part of the session.  The
standalone scopes, the CaptureHub and InteractiveROI are compared on their
own."""

import dataclasses

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu import config as J
from obs_color_monitor_tpu import models as jm
from obs_color_monitor_tpu.models import roi_interact as jri
from obs_color_monitor_tpu_torch import models as tm
from obs_color_monitor_tpu_torch.config import from_reference
from obs_color_monitor_tpu_torch.models import roi_interact as tri

torch.set_num_threads(1)

H, W = 48, 96  # the JAX stream tests' captures (tests/test_stream_step.py:30)
PANEL = dict(width=128, height=700)


def _rgba(rng, shape=(H, W)):
    f = rng.integers(0, 256, shape + (4,), dtype=np.uint8)
    f[..., 3] = np.where(rng.random(shape) < 0.05, 0, 255)
    return f


def _docks():
    # the histogram in PIXEL level mode keeps its fill test away from exact
    # ties, where JAX's CPU render departs from golden
    # (tests/test_torch_dynamic_roi.py::test_histogram_tie_follows_golden)
    kw = dict(config=J.DockConfig(show_roi=True, show_focuspeaking=True),
              roi=J.ROIConfig(target_scale=1, interleave=0),
              histogram=J.HistogramConfig(level_mode=J.LevelMode.PIXEL),
              falsecolor=J.FalseColorConfig(show_key=J.ShowKey.RIGHT))
    jd = jm.Dock(**kw)
    td = tm.Dock(**{k: from_reference(v) for k, v in kw.items()}, device="cpu")
    return jd, td


def _np(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _snap(d) -> dict:
    """What a caller can read of a dock: the scopes' published statistics
    and buffers, the counters, the last surface and the mouse geometry."""
    s = d.hub.last_surface
    hi = d.histogram._read()
    zb = d.zebra._read()
    ri = d.roi_interact
    return {
        "hist": d.histogram.counts(),
        "hist_n": None if hi is None else int(hi[1]),
        "wave": d.waveform.counts(),
        "wave_width": d.waveform.width,
        "vs": _np(d.vectorscope._read()),
        "zebra_planes": None if zb is None else _np(zb[0]),
        "preview": _np(d.roi_preview._read()),
        "processed": d.hub.frames_processed,
        "skipped": d.hub.frames_skipped,
        "pending": d._pending is not None,
        # not ``cropped``: JAX's one-program stream route leaves it False on
        # a crop, where its hub route (tests/test_stream_step.py:881) and the
        # port's one route set it
        "surface": None if s is None else (s.width, s.height, s.dynamic_rect),
        "rects": dict(d._rects),
        "roi_view": (d._roi_shows_crop, tuple(d._roi_crop_origin)),
        "interact": None if ri is None else (ri.flags, ri.rect(), ri.sizing_rect()),
        "hub_rect": d.hub.config.resolve_rect(W, H),
    }


def _panel_to_panel(d, sx, sy):
    """The panel pixel that maps back to capture pixel (sx, sy) through the
    roi band (the smallest one: _hit floors)."""
    x0b, y0b, wb, hb, ws, hs = d._rects["roi"]
    ox, oy = d._roi_crop_origin
    return x0b + -(-(sx - ox) * wb // ws), y0b + -(-(sy - oy) * hb // hs)


@pytest.fixture(scope="module")
def session():
    """Run the scripted session on both docks; returns {part: [(step,
    jax value, port value)]}."""
    rng = np.random.default_rng(0xD0C)
    jd, td = _docks()
    log: dict[str, list] = {}

    def both(fn):
        return fn(jd), fn(td)

    def check(part, step, panels=None):
        rec = log.setdefault(part, [])
        if panels is not None:
            rec.append((f"{step} panel", _np(panels[0]), _np(panels[1])))
        a, b = _snap(jd), _snap(td)
        for k in a:
            rec.append((f"{step} {k}", a[k], b[k]))

    # push/render alternation (tests/test_stream_step.py:58)
    for i in range(4):
        f = _rgba(rng)
        both(lambda d: d.push_frame(f))
        check("alternation", f"frame {i} pushed")
        check("alternation", f"frame {i}", both(lambda d: d.render(**PANEL)))
    # pushes without a render between them (:140)
    for i in range(2):
        f = _rgba(rng)
        both(lambda d: d.push_frame(f))
        check("push_without_render", f"push {i}")
    check("push_without_render", "render", both(lambda d: d.render(**PANEL)))
    # flush (:394)
    f = _rgba(rng)
    both(lambda d: d.push_frame(f))
    check("flush", "pushed")
    both(lambda d: d.flush())
    check("flush", "flushed")
    check("flush", "render", both(lambda d: d.render(**PANEL)))
    # a live move-drag (:225): a rect change, then a drag across frames
    both(lambda d: d.hub.set_roi(10, 8, 60, 40))
    f = _rgba(rng)
    both(lambda d: d.push_frame(f))
    check("drag", "rect changed", both(lambda d: d.render(**PANEL)))
    both(lambda d: d.mouse_move(*_panel_to_panel(d, 30, 20)))
    both(lambda d: d.mouse_down(*_panel_to_panel(d, 30, 20)))
    check("drag", "grabbed")
    for i in range(4):
        both(lambda d: d.mouse_move(*_panel_to_panel(d, 30 + 2 * (i + 1), 20 + (i % 2))))
        f = _rgba(rng)
        both(lambda d: d.push_frame(f))
        check("drag", f"drag frame {i}", both(lambda d: d.render(**PANEL)))
    both(lambda d: d.mouse_up(*_panel_to_panel(d, 38, 21)))
    both(lambda d: d.mouse_move(0, 699))  # park off the band
    for i in range(3):  # settles: the fan-out resumes at the new rect
        f = _rgba(rng)
        both(lambda d: d.push_frame(f))
        check("drag", f"settle frame {i}", both(lambda d: d.render(**PANEL)))
    # the hover outline over a settled crop view
    both(lambda d: d.mouse_move(*_panel_to_panel(d, 45, 25)))
    check("drag", "hover", both(lambda d: d.render(**PANEL)))
    both(lambda d: d.mouse_move(0, 699))
    # NV12 pushes (:752), with a rect change on the way (:788)
    for i in range(4):
        y = rng.integers(0, 256, (H, W), np.uint8)
        uv = rng.integers(0, 256, (H // 2, W), np.uint8)
        if i == 2:
            both(lambda d: d.hub.set_roi(4, 6, 70, 44))
        both(lambda d: d.push_nv12(y, uv))
        check("nv12", f"frame {i}", both(lambda d: d.render(**PANEL)))
    # P010 pushes (:999): real P010, 10 bits at the top of 16
    both(lambda d: d.hub.set_roi(-1, -1, -1, -1))
    for i in range(3):
        y = (rng.integers(0, 1 << 10, (H, W)) << 6).astype(np.uint16)
        uv = (rng.integers(0, 1 << 10, (H // 2, W)) << 6).astype(np.uint16)
        both(lambda d: d.push_nv12(y, uv, shift=8))
        check("p010", f"frame {i}", both(lambda d: d.render(**PANEL)))
    # interleave 1 (the reference default): every other frame skipped
    both(lambda d: setattr(d.hub.config, "interleave", 1))
    for i in range(4):
        f = _rgba(rng)
        both(lambda d: d.push_frame(f))
        check("interleave", f"frame {i}", both(lambda d: d.render(**PANEL)))
    both(lambda d: setattr(d.hub.config, "interleave", 0))
    # bypass: the waveform shows the capture, through the hub every frame
    both(lambda d: setattr(d.waveform.config, "bypass", True))
    for i in range(2):
        f = _rgba(rng)
        both(lambda d: d.push_frame(f))
        check("bypass", f"frame {i}", both(lambda d: d.render(**PANEL)))
    return log


def _assert_part(session, part):
    assert session[part]
    for step, a, b in session[part]:
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None, step
            assert a.shape == b.shape, step
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), step
        else:
            assert a == b, step


@pytest.mark.parametrize("part", ["alternation", "push_without_render", "flush", "drag",
                                  "nv12", "p010", "interleave", "bypass"])
def test_dock_session_matches_jax(session, part):
    _assert_part(session, part)


def test_deferral_and_drag_are_exercised(session):
    """The session reached the routes it means to compare: a deferred
    frame, a dynamic-rect publication and a settled crop view."""
    rec = {step: b for step, _, b in (session["alternation"] + session["flush"]
                                      + session["drag"])}
    assert rec["frame 3 pushed pending"] and rec["pushed pending"]
    assert rec["drag frame 2 surface"][2] is not None
    assert rec["settle frame 2 roi_view"][0]


def _frame_of(kind, rng):
    f = _rgba(rng)
    if kind == "packed":
        return f, f.view(np.uint32)[..., 0]
    return f, f


@pytest.mark.parametrize("scope,cfg", [
    ("Vectorscope", J.VectorscopeConfig(zoom=1.7)),
    ("Waveform", J.WaveformConfig(display=J.DisplayMode.PARADE)),
    ("Histogram", J.HistogramConfig(level_mode=J.LevelMode.PIXEL, components=J.Components.YUV)),
    ("Zebra", J.ZebraConfig()),
    ("FalseColor", J.FalseColorConfig(show_key=J.ShowKey.BELOW)),
    ("FocusPeaking", J.FocusPeakingConfig(peaking_threshold=0.05)),
])
def test_standalone_scope_matches_jax(scope, cfg):
    """A scope on its own private hub: push, tick, render, over 3 frames."""
    rng = np.random.default_rng(len(scope))
    js = getattr(jm, scope)(cfg)
    ts = getattr(tm, scope)(from_reference(cfg), device="cpu")
    for i in range(3):
        f = _rgba(rng, (36, 64))
        js.push_frame(f)
        ts.push_frame(f)
        a, b = js.render(), ts.render()
        assert (a is None) == (b is None), i
        if a is not None:
            assert np.array_equal(a, b), i
        if hasattr(js, "counts"):
            assert np.array_equal(js.counts(), ts.counts()), i
        assert (js.width, js.height) == (ts.width, ts.height)


def test_capture_hub_matches_jax():
    """The hub's fan-out: union of needs, a static crop, interleave, and a
    frame too small for the scale."""
    rng = np.random.default_rng(5)
    jh = jm.CaptureHub(J.ROIConfig(target_scale=2, interleave=1, x0=3, y0=2, x1=30, y1=20))
    th = tm.CaptureHub(from_reference(jh.config), device="cpu")
    jv, tv = jm.Vectorscope(), tm.Vectorscope(device="cpu")
    jw = jm.Waveform(J.WaveformConfig(components=J.Components.YUV))
    tw = tm.Waveform(from_reference(jw.config), device="cpu")
    for h, v, w in ((jh, jv, jw), (th, tv, tw)):
        h.register(v)
        h.register(w)
    assert dataclasses.asdict(th.union_needs()) == dataclasses.asdict(jh.union_needs())
    for i in range(4):
        f = _rgba(rng)
        for h in (jh, th):
            h.tick()
        a, b = jh.process(f), th.process(f)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.width, a.height, a.cropped) == (b.width, b.height, b.cropped)
            for name in ("vs_counts", "wv_yuv", "planes", "yuv_planes"):
                x, y = getattr(a.result, name), getattr(b.result, name)
                assert np.array_equal(np.asarray(x), y.numpy()), name
        assert np.array_equal(np.asarray(jv._read()), tv._read().numpy())
        assert np.array_equal(jw.counts(), tw.counts())
    assert (th.frames_processed, th.frames_skipped) == (jh.frames_processed, jh.frames_skipped)
    for h in (jh, th):
        h.tick()
        h.tick()
    assert th.process(_rgba(rng, (1, 1))) is None and jh.process(_rgba(rng, (1, 1))) is None
    assert th.frames_skipped == jh.frames_skipped


# the event scripts of tests/test_roi_interact.py, replayed on both state
# machines: (constructor fields, [(event, args)])
ROI_SCRIPTS = {
    "first_drag": ({}, [("move", (20, 10)), ("down", (20, 10)), ("move", (80, 60)),
                        ("up", (80, 60))]),
    "degenerate_drag": ({}, [("move", (20, 10)), ("down", (20, 10)), ("up", (20, 50))]),
    "move_drag": (dict(x0in=50, y0in=40, x1in=150, y1in=100),
                  [("move", (100, 70)), ("down", (100, 70)), ("move", (110, 75)),
                   ("up", (110, 75))]),
    "resize_left": (dict(x0in=50, y0in=20, x1in=150, y1in=100),
                    [("move", (52, 60)), ("down", (52, 60)), ("move", (30, 60)),
                     ("up", (30, 60))]),
    "resize_crossing": (dict(x0in=50, y0in=20, x1in=150, y1in=100),
                        [("move", (52, 60)), ("down", (52, 60)), ("up", (170, 60))]),
    "outside_handles": (dict(x0in=60, y0in=50, x1in=80, y1in=70),
                        [("move", (55, 60)), ("down", (55, 60)), ("move", (50, 62)),
                         ("up", (50, 62))]),
    "leave": (dict(x0in=50, y0in=20, x1in=150, y1in=100),
              [("move", (100, 60)), ("leave", (0, 0))]),
}


@pytest.mark.parametrize("name", sorted(ROI_SCRIPTS))
def test_roi_interact_matches_jax(name):
    fields, events = ROI_SCRIPTS[name]
    j = jri.InteractiveROI(width=192, height=108, **fields)
    t = tri.InteractiveROI(width=192, height=108, **fields)
    for ev, args in events:
        for r in (j, t):
            if ev == "leave":
                r.mouse_move(*args, leave=True)
            else:
                getattr(r, f"mouse_{ev}")(*args)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (ev, args)
        assert t.rect() == j.rect() and t.sizing_rect() == j.sizing_rect()
        assert t.indicator_segments() == j.indicator_segments()
    hubs = (jm.CaptureHub(J.ROIConfig(target_scale=1)),
            tm.CaptureHub(from_reference(J.ROIConfig(target_scale=1)), device="cpu"))
    j.apply_to(hubs[0])
    t.apply_to(hubs[1])
    assert hubs[1].config.resolve_rect(192, 108) == hubs[0].config.resolve_rect(192, 108)


def test_roi_interact_is_the_jax_module():
    """The port's copy equals the JAX module but for its docstring."""
    import inspect

    strip = lambda m: inspect.getsource(m).split('"""', 2)[2]
    assert strip(tri) == strip(jri)
