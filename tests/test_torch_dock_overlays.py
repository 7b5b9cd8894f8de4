"""The settled Dock's overlay launches: the shown overlay scopes that take
kernel K3 and read the same planes share one ``fused_overlays_planes``
call per render (``models.overlays.shared_overlay_images``); a user-LUT or
key-legend false colour, a bypassed scope and a lone overlay keep their
own routes.  The calls are counted on the CPU with a monkeypatch, and every
panel is held equal to the per-scope route (the shared call switched off)
and to the JAX Dock fed the same frames, exact."""

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu import config as J
from obs_color_monitor_tpu import models as jm
from obs_color_monitor_tpu_torch import models as tm
from obs_color_monitor_tpu_torch.config import from_reference
from obs_color_monitor_tpu_torch.models import dock as tdock
from obs_color_monitor_tpu_torch.models import overlays as tov

torch.set_num_threads(1)

H, W = 48, 96
PANEL = dict(width=128, height=700)
FRAMES = 3
LUT = np.random.default_rng(11).integers(0, 256, (40, 4), np.uint8)
ALL, ZB_FP = (True, True, True), (True, False, True)

# configuration -> (JAX configs, the outputs of each K3 call one render makes)
CASES = {
    "three": (dict(config=J.DockConfig(show_focuspeaking=True)), [ALL]),
    "two": (dict(config=J.DockConfig(show_falsecolor=False, show_focuspeaking=True)), [ZB_FP]),
    "lut": (dict(config=J.DockConfig(show_focuspeaking=True),
                 falsecolor=J.FalseColorConfig(use_lut=True, lut=LUT)), [ZB_FP]),
    "key": (dict(config=J.DockConfig(show_focuspeaking=True),
                 falsecolor=J.FalseColorConfig(show_key=J.ShowKey.RIGHT)),
            [ZB_FP, (False, True, False)]),
    "colorspaces": (dict(config=J.DockConfig(show_focuspeaking=True),
                         zebra=J.ZebraConfig(colorspace=1, zebra_th_low=60),
                         falsecolor=J.FalseColorConfig(colorspace=2),
                         focuspeaking=J.FocusPeakingConfig(peaking_threshold=0.02)), [ALL]),
    "one": (dict(config=J.DockConfig(show_falsecolor=False)), [(True, False, False)]),
    "bypass": (dict(config=J.DockConfig(show_focuspeaking=True),
                    zebra=J.ZebraConfig(bypass=True)),
               [(False, True, True), (True, False, False)]),
}


def _kw(case):
    # the histogram in PIXEL level mode keeps its fill test away from exact
    # ties, where JAX's CPU render departs from golden
    # (tests/test_torch_dynamic_roi.py::test_histogram_tie_follows_golden)
    return dict(CASES[case][0], roi=J.ROIConfig(target_scale=1, interleave=0),
                histogram=J.HistogramConfig(level_mode=J.LevelMode.PIXEL))


def _port_dock(case):
    return tm.Dock(**{k: from_reference(v) for k, v in _kw(case).items()}, device="cpu")


def _frames():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(FRAMES):
        f = rng.integers(0, 256, (H, W, 4), np.uint8)
        f[..., 3] = np.where(rng.random((H, W)) < 0.05, 0, 255)
        out.append(f)
    return out


@pytest.fixture
def k3_calls(monkeypatch):
    """Every fused_overlays_planes call the overlay scopes make: its
    ``outputs``."""
    calls = []
    real = tov.fused_overlays_planes

    def counted(*args, **kw):
        calls.append(tuple(kw["outputs"]))
        return real(*args, **kw)

    monkeypatch.setattr(tov, "fused_overlays_planes", counted)
    return calls


def _run(dock, calls):
    """Push and render every frame; the panels and each render's calls."""
    panels, per_render = [], []
    for f in _frames():
        dock.push_frame(f)
        del calls[:]
        panels.append(dock.render(**PANEL))
        per_render.append(sorted(calls))
    return panels, per_render


@pytest.mark.parametrize("case", sorted(CASES))
def test_settled_dock_overlay_launches(case, k3_calls):
    _, per_render = _run(_port_dock(case), k3_calls)
    assert per_render == [sorted(CASES[case][1])] * FRAMES


@pytest.mark.parametrize("case", sorted(CASES))
def test_shared_launch_panel_equals_per_scope_route(case, k3_calls, monkeypatch):
    shared, calls = _run(_port_dock(case), k3_calls)
    monkeypatch.setattr(tdock, "shared_overlay_images", lambda scopes: {})
    per_scope, calls_alone = _run(_port_dock(case), k3_calls)
    # the per-scope route launches K3 once for each overlay it renders
    assert all(len(c) == sum(sum(o) for o in CASES[case][1]) for c in calls_alone)
    for a, b in zip(shared, per_scope):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shared_launch_panel_equals_jax(case):
    panels, _ = _run(_port_dock(case), [])
    jd = jm.Dock(**_kw(case))
    for f, got in zip(_frames(), panels):
        jd.push_frame(f)
        want = np.asarray(jd.render(**PANEL))
        assert got.shape == want.shape and np.array_equal(got, want)


def test_shared_overlay_images_groups_by_planes():
    """Scopes on different planes tensors, or a second scope of one kind,
    are left to their own routes; the images served equal render_image."""
    rng = np.random.default_rng(3)
    zb, fc, fp, fp2 = (tm.Zebra(device="cpu"), tm.FalseColor(device="cpu"),
                       tm.FocusPeaking(device="cpu"), tm.FocusPeaking(device="cpu"))
    f = rng.integers(0, 256, (24, 40, 4), np.uint8)
    for s in (zb, fc, fp, fp2):
        s.push_frame(f)  # each on its own hub: four planes tensors
    assert tov.shared_overlay_images([zb, fc, fp, fp2]) == {}
    planes = zb._read()
    for s in (fc, fp, fp2):
        s._buf[s._w_buf ^ 1] = planes
    zb.tick()
    got = tov.shared_overlay_images([zb, fc, fp, fp2])
    assert set(got) == {zb, fc, fp}
    for s, img in got.items():
        assert torch.equal(img, s.render_image())
