"""The host side of KR, the stats scopes' images in one launch
(``ops/render.draw_stat_images``), on the CPU: the job table that each
route builds (the dock step's ``_stat_renders``, the Dock's composite, a
scope's own ``render_image``) for every display mode, component family,
colour type, level mode and zoom, the kernel's by-value table, the
wrapper's argument checks, its plain branch against the golden renders on
odd widths, and the one draw of each Dock frame on every route.
The kernel itself runs on a card only (``tests/test_torch_cuda.py``,
``test_scope_render_*``)."""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu_torch import DockConfig, make_dock_step
from obs_color_monitor_tpu_torch import config as cfg
from obs_color_monitor_tpu_torch.colorspace import calc_colorspace
from obs_color_monitor_tpu_torch.golden import reference as golden
from obs_color_monitor_tpu_torch.golden import render as golden_render
from obs_color_monitor_tpu_torch.graphs import _counters
from obs_color_monitor_tpu_torch.models import Dock, Histogram, Vectorscope, Waveform
from obs_color_monitor_tpu_torch.ops import render as R
from obs_color_monitor_tpu_torch.ops.graticule import (
    composite_overlay,
    histogram_graticule,
    vectorscope_graticule,
    waveform_graticule,
)
from obs_color_monitor_tpu_torch.pipeline import profiler

torch.set_num_threads(1)

H, W = 60, 88  # a 44x30 capture at scale 2
SW, SH = W // 2, H // 2
FAMILIES = {"rgb": cfg.Components.RGB, "y": cfg.Components.Y, "uv": cfg.Components.UV,
            "yuv": cfg.Components.YUV}
DISPLAYS = {"overlay": cfg.DisplayMode.OVERLAY, "stack": cfg.DisplayMode.STACK,
            "parade": cfg.DisplayMode.PARADE}
COLOURS = {"white": cfg.VectorscopeColorType.WHITE, "uv": cfg.VectorscopeColorType.UV}
LEVELS = {"auto": cfg.LevelMode.AUTO, "pixel": cfg.LevelMode.PIXEL, "ratio": cfg.LevelMode.RATIO}
ZOOMS = {"zoom1": 1.0, "zoom2.5": 2.5}
MATRIX = list(itertools.product(DISPLAYS, FAMILIES, COLOURS, LEVELS, ZOOMS))
DRAW = R.draw_stat_images  # the wrapper itself, which a test's spy wraps


def _configs(display, family, colour, level, zoom, logscale=False):
    """The three stats scopes' configurations of one matrix case."""
    comps, disp = FAMILIES[family], DISPLAYS[display]
    return dict(
        vectorscope=cfg.VectorscopeConfig(color_type=COLOURS[colour], zoom=ZOOMS[zoom],
                                          intensity=7),
        waveform=cfg.WaveformConfig(components=comps, display=disp, intensity=9),
        histogram=cfg.HistogramConfig(components=comps, display=disp, level_mode=LEVELS[level],
                                      level_fixed_value=60, level_ratio_value=3.5,
                                      logscale=logscale, level_height=50),
    )


class _Spy:
    """Records every job table handed to ``draw_stat_images``."""

    def __init__(self, mp):
        self.calls, wrapper = [], R.draw_stat_images

        def spy(jobs):
            jobs = list(jobs)
            self.calls.append(jobs)
            return wrapper(jobs)

        mp.setattr(R, "draw_stat_images", spy)


def _frame(seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (H, W, 4), np.uint8))


def _golden_image(job: R.StatJob) -> np.ndarray:
    """The job's image from the golden renders (``golden/render.py``), its
    hi_max and levels from ``golden/reference.py``, the graticule
    composited on the host; the zoom by the port's ``zoom_center``, held to
    JAX's in ``tests/test_torch_dock_step.py``."""
    c = job.counts.numpy()
    grat = None if job.graticule is None else job.graticule.numpy()
    if job.kind == R.VECTORSCOPE:
        img = composite_overlay(golden_render.render_vectorscope(c, job.intensity, job.cs,
                                                                 job.white), grat)
        return R.zoom_center(torch.from_numpy(np.ascontiguousarray(img)), job.zoom).numpy()
    sel = np.asarray(job.sel)
    c = c * sel.reshape((3,) + (1,) * (c.ndim - 1)).astype(c.dtype)
    if job.kind == R.WAVEFORM:
        img = golden_render.render_waveform(c, job.intensity, job.display, job.n_components,
                                            job.yuv_mode)
    else:
        comps = _family_of(job.sel, job.yuv_mode)
        n_px = int(job.n_pixels)
        hi = golden.histogram_hi_max(c, comps, n_px, 1, job.level_fixed,
                                     job.level_ratio_permille)
        levels, hi_eff = golden.histogram_levels(c, hi, comps, job.logscale)
        img = golden_render.render_histogram(levels, hi_eff, job.level_height, job.display,
                                             job.n_components, job.yuv_mode)
    return composite_overlay(img, grat)


def _family_of(sel, yuv):
    """The Components value whose channel selection is ``sel``."""
    for v in range(0x80):
        c = cfg.Components(v)
        if c.is_yuv == yuv and c.channel_select() == tuple(sel) and (yuv or not v & 0x70):
            return c
    raise AssertionError(sel)


def _check_job_images(jobs):
    """The plain branch's image of each job equals the golden one."""
    for job, img in zip(jobs, DRAW(jobs)):
        assert img.dtype == torch.uint8 and tuple(img.shape) == (*R.stat_image_shape(job), 4)
        assert np.array_equal(img.numpy(), _golden_image(job)), job.kind


def _expect_jobs(jobs, confs, n_pixels):
    """Each job of the step's table carries its scope's settings."""
    vs, wv, hi = confs["vectorscope"], confs["waveform"], confs["histogram"]
    assert [j.kind for j in jobs] == [R.VECTORSCOPE, R.WAVEFORM, R.HISTOGRAM]
    v, w, h = jobs
    assert (v.intensity, v.cs, v.white, v.zoom) == (
        7, int(calc_colorspace(0)), vs.color_type == cfg.VectorscopeColorType.WHITE,
        round(vs.zoom, 3))
    assert v.counts.shape == (256, 256) and v.graticule.shape == (256, 256, 4)
    assert (w.intensity, w.display, w.n_components, w.yuv_mode, w.sel) == (
        9, int(wv.display), wv.components.n_components, wv.components.is_yuv,
        wv.components.channel_select())
    assert w.counts.shape == (3, 256, SW) and w.counts.dtype == torch.uint8
    assert (h.display, h.n_components, h.yuv_mode, h.sel, h.level_height, h.logscale) == (
        int(hi.display), hi.components.n_components, hi.components.is_yuv,
        hi.components.channel_select(), 50, hi.logscale)
    assert (h.level_fixed, h.level_ratio_permille) == (hi.level_fixed, hi.level_ratio_permille)
    assert h.counts.shape == (3, 256) and h.counts.dtype == torch.int32
    assert int(h.n_pixels) == n_pixels
    for j in jobs:
        assert j.graticule is None or tuple(j.graticule.shape) == (*R.stat_image_shape(j), 4)


@pytest.mark.parametrize("display,family,colour,level,zoom", MATRIX)
def test_step_job_table(display, family, colour, level, zoom, monkeypatch):
    """The dock step's ``_stat_renders`` hands the shown scopes' jobs to
    one draw, in the static step (the capture's pixel count) and the
    dynamic step (the rect's, a 0-d tensor read on the device), for every
    display mode x component family x colour type x level mode x zoom; the
    images equal the golden renders."""
    logscale = (len(display) + len(family) + len(level)) % 2 == 0
    confs = _configs(display, family, colour, level, zoom, logscale)
    spy = _Spy(monkeypatch)
    make_dock_step(H, W, out_width=128, out_height=400, device="cpu", **confs)(_frame(), 0.5)
    assert len(spy.calls) == 1
    _expect_jobs(spy.calls[0], confs, SW * SH)
    _check_job_images(spy.calls[0])
    rect = (5, 4, 30, 20)
    make_dock_step(H, W, out_width=128, out_height=400, device="cpu", dynamic_roi=True,
                   **confs)(_frame(), 0.5, torch.tensor(rect, dtype=torch.int32))
    assert len(spy.calls) == 2
    _expect_jobs(spy.calls[1], confs, 25 * 16)
    hi_job = spy.calls[1][2]
    assert isinstance(hi_job.n_pixels, torch.Tensor) and hi_job.n_pixels.dtype == torch.int64
    _check_job_images(spy.calls[1])


def test_step_hidden_scopes_draw_the_rest(monkeypatch):
    """A step with the waveform hidden draws the other two in one call;
    one with no stats scope shown draws nothing."""
    spy = _Spy(monkeypatch)
    make_dock_step(H, W, dock=DockConfig(show_waveform=False), device="cpu")(_frame(), 0.5)
    assert [[j.kind for j in c] for c in spy.calls] == [[R.VECTORSCOPE, R.HISTOGRAM]]
    none = DockConfig(show_vectorscope=False, show_waveform=False, show_histogram=False)
    make_dock_step(H, W, dock=none, device="cpu")(_frame(), 0.5)
    assert [len(c) for c in spy.calls] == [2, 0]


def _dock(device="cpu", interleave=0, **confs):
    return Dock(DockConfig(), roi=cfg.ROIConfig(interleave=interleave, target_scale=2),
                device=device, **confs)


def _push(dock, n, seed=2):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        b = rng.integers(0, 256, (72, 96), dtype=np.uint8)
        dock.push_nv12(b[:48], b[48:])
        dock.render_async()


@pytest.mark.parametrize("case", range(0, len(MATRIX), 7))
def test_dock_composite_draws_the_stats_scopes_once(case, monkeypatch):
    """``Dock._composite`` hands its three stats scopes' jobs to one draw,
    each job its scope's own ``stat_job``; a scope's ``render_image`` draws
    its one job, the same image."""
    confs = _configs(*MATRIX[case], logscale=case % 2 == 1)
    dock = _dock(**confs)
    _push(dock, 3)
    spy = _Spy(monkeypatch)
    panel, _, all_shown = dock._composite(128, 400, ["roi", "vectorscope", "waveform",
                                                    "histogram", "zebra"])
    assert all_shown and panel.shape == (400, 128, 4)
    scopes = (dock.vectorscope, dock.waveform, dock.histogram)
    assert len(spy.calls) == 1
    assert [j.kind for j in spy.calls[0]] == [R.VECTORSCOPE, R.WAVEFORM, R.HISTOGRAM]
    for job, scope in zip(spy.calls[0], scopes):
        own = scope.stat_job()
        assert job._replace(counts=None, graticule=None, n_pixels=None) == own._replace(
            counts=None, graticule=None, n_pixels=None)
        assert torch.equal(job.counts, own.counts) and job.graticule is own.graticule
    _check_job_images(spy.calls[0])
    for scope, img in zip(scopes, [R.draw_stat_plain(j) for j in spy.calls[0]]):
        n = len(spy.calls)
        assert torch.equal(scope.render_image(), img)
        assert len(spy.calls) == n + 1 and len(spy.calls[-1]) == 1


def test_standalone_scopes_draw_their_job():
    """A standalone scope's ``render_image`` is its job's image; bypassed
    or with nothing published it has no job."""
    f = np.random.default_rng(4).integers(0, 256, (H, W, 4), np.uint8)
    for make in (Vectorscope, Waveform, Histogram):
        scope = make(device="cpu")
        assert scope.stat_job() is None and scope.render_image() is None
        scope.push_frame(f)
        scope.tick()
        job = scope.stat_job()
        assert job is not None
        assert torch.equal(scope.render_image(), R.draw_stat_plain(job))
        scope.update(bypass=True)
        assert scope.stat_job() is None


def _jobs(display="parade", family="yuv", colour="uv", level="ratio", zoom="zoom2.5",
          rect=(5, 4, 30, 20), monkeypatch=None):
    spy = _Spy(monkeypatch)
    confs = _configs(display, family, colour, level, zoom)
    make_dock_step(H, W, out_width=128, out_height=400, device="cpu", dynamic_roi=True,
                   **confs)(_frame(), 0.5, torch.tensor(rect, dtype=torch.int32))
    return spy.calls[0]


@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("display", sorted(DISPLAYS))
def test_launch_params_mirror_the_table(display, level, monkeypatch):
    """The kernel's by-value table: each job's image, block range, display
    as drawn, bands, orders, tints and addresses; the histogram's hi_max
    mode (the ratio of a device pixel count here); the mirror has
    RenderParams' C layout."""
    jobs = _jobs(display=display, level=level, monkeypatch=monkeypatch)
    outs = [torch.empty((*R.stat_image_shape(j), 4), dtype=torch.uint8) for j in jobs]
    p = R.launch_params(jobs, outs)
    assert p.n_jobs == 3
    block0 = 0
    for i, (job, out) in enumerate(zip(jobs, outs)):
        q = p.jobs[i]
        h, w = R.stat_image_shape(job)
        assert (q.kind, q.out_h, q.out_w, q.block0) == (job.kind, h, w, block0)
        block0 += -(-(-(-w // 4) * h) // 256)
        assert q.vec == int(w % 4 == 0)
        assert (q.counts, q.out) == (job.counts.data_ptr(), out.data_ptr())
        assert q.overlay == job.graticule.data_ptr()
        if job.kind == R.VECTORSCOPE:
            assert (q.intensity, q.white) == (7, 0)
            assert q.zoom == R._zoom_index(256, 2.5, out.device).data_ptr()
            C, Cu, Cv = R._vs_tint(job.cs)
            assert [list(r) for r in q.tint] == [[C[c], Cu[c], Cv[c]] for c in range(3)]
            continue
        assert list(q.order) == list(R.DISP_YUV) and list(q.sel) == [1, 1, 1]
        n = 1 if display == "overlay" else 3
        assert (q.display, q.n_bands) == (int(DISPLAYS[display]) if n > 1 else 0, n)
        assert list(q.bands) == [0, 1, 2]
        tint = R.TINT_Q12 if job.kind == R.WAVEFORM else R.TINT_U8
        assert [list(r) for r in q.tint] == tint.tolist()
        if job.kind == R.WAVEFORM:
            assert (q.intensity, q.band_h, q.band_w) == (9, 256, SW)
        else:
            assert (q.band_h, q.band_w, q.logscale) == (50, 256, 0)
            mode, hi, npx = {"auto": (2, 0, None), "pixel": (0, 60, None),
                             "ratio": (1, 35, job.n_pixels)}[level]
            assert (q.hi_mode, q.hi) == (mode, hi)
            assert q.n_pixels == (None if npx is None else npx.data_ptr())
    assert p.blocks == block0
    assert ctypes.sizeof(R._Job) == 176 and R._Job.hi.offset == 128
    assert R._Params.jobs.offset == 8 and ctypes.sizeof(R._Params) == 8 + 176 * R.MAX_JOBS


def test_launch_params_host_ratio_and_two_bands():
    """A host pixel count in ratio mode becomes the host's hi_max; two
    components draw bands 0 and 2; an odd width or an unaligned graticule
    leaves the 16-byte form."""
    counts = torch.zeros((3, 256), dtype=torch.int32)
    job = R.histogram_job(counts, None, (True, False, True), 1000, 0, 35, False, 50,
                          int(cfg.DisplayMode.STACK), 2, True)
    q = R.launch_params([job], [torch.empty((100, 256, 4), dtype=torch.uint8)]).jobs[0]
    assert (q.hi_mode, q.hi, q.n_pixels) == (0, 35, None)
    assert (q.n_bands, list(q.bands), q.out_h) == (2, [0, 2, 0], 100)
    wv = torch.zeros((3, 256, 13), dtype=torch.uint8)
    grat = torch.zeros(256 * 13 * 4 + 4, dtype=torch.uint8)[4:].view(256, 13, 4)
    job = R.waveform_job(wv, grat, (True,) * 3, 1, 0, 3, False)
    assert R.launch_params([job], [torch.empty((256, 13, 4), dtype=torch.uint8)]).jobs[0].vec == 0
    grat = torch.zeros((256, 16, 4), dtype=torch.uint8)
    big = torch.zeros(256 * 16 * 4 + 4, dtype=torch.uint8)[4:].view(256, 16, 4)
    job = R.waveform_job(wv.new_zeros((3, 256, 16)), grat, (True,) * 3, 1, 0, 3, False)
    assert R.launch_params([job], [torch.empty((256, 16, 4), dtype=torch.uint8)]).jobs[0].vec
    assert R.launch_params([job._replace(graticule=big)],
                           [torch.empty((256, 16, 4), dtype=torch.uint8)]).jobs[0].vec == 0


def test_checks_refuse_what_the_kernel_does_not_take(monkeypatch):
    """Dtype, shape, device and contiguity of counts, graticule and pixel
    count, an unknown kind, more than three jobs: ValueError; a device
    that is neither the CPU nor a card too."""
    jobs = _jobs(monkeypatch=monkeypatch)
    R.check_stat_jobs(jobs)
    v, w, h = jobs
    meta = torch.empty((3, 256, SW), dtype=torch.uint8, device="meta")
    bad = {
        "vs_dtype": [v._replace(counts=v.counts.to(torch.int32)), w, h],
        "vs_shape": [v._replace(counts=v.counts[:255]), w, h],
        "wv_dtype": [v, w._replace(counts=w.counts.to(torch.int32)), h],
        "wv_shape": [v, w._replace(counts=w.counts[:2]), h],
        "wv_strided": [v, w._replace(counts=torch.zeros((3, 256, 2 * SW), dtype=torch.uint8)
                                     [:, :, ::2]), h],
        "wv_device": [v, w._replace(counts=meta), h],
        "hi_dtype": [v, w, h._replace(counts=h.counts.to(torch.int64))],
        "hi_numpy": [v, w, h._replace(counts=h.counts.numpy())],
        "npx_dtype": [v, w, h._replace(n_pixels=h.n_pixels.to(torch.int32))],
        "npx_shape": [v, w, h._replace(n_pixels=h.n_pixels.reshape(1))],
        "grat_shape": [v._replace(graticule=v.graticule[:, :128]), w, h],
        "grat_dtype": [v, w._replace(graticule=w.graticule.to(torch.int32)), h],
        "grat_strided": [v, w, h._replace(graticule=torch.zeros(
            (50, 512, 4), dtype=torch.uint8)[:, ::2] if h.graticule.shape[1] == 256
            else h.graticule[:, ::2])],
        "kind": [v._replace(kind=3), w, h],
        "four": [v, w, h, v],
    }
    for what, js in bad.items():
        with pytest.raises(ValueError):
            R.check_stat_jobs(js)
            pytest.fail(what)
    with pytest.raises(ValueError):
        DRAW([v._replace(counts=v.counts.to("meta"))])
    assert DRAW([]) == []


MODES = [(d, n, y) for d in (0, 1, 2) for n in (1, 2, 3) for y in (False, True)]


@pytest.mark.parametrize("width", [13, 17, 130, 131, 132])
def test_plain_waveform_equals_golden_on_odd_widths(width):
    """The plain branch's waveform, every display x components x order, on
    the odd widths of the kernel tests, with its graticule and a channel
    left out: the golden render, selected, composited."""
    rng = np.random.default_rng(width)
    counts = rng.integers(0, 256, (3, 256, width), np.uint8)
    counts[..., :3] = 0
    for k, (d, n, y) in enumerate(MODES):
        grat = waveform_graticule(1 + k % 3, width, d, n)
        sel = ((True, True, True), (True, False, True), (False, True, True))[k % 3]
        job = R.waveform_job(torch.from_numpy(counts), None if grat is None else
                             torch.from_numpy(np.ascontiguousarray(grat)), sel, 1 + k % 5, d, n,
                             y)
        _check_job_images([job])


@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("logscale", [False, True])
def test_plain_histogram_equals_golden(level, logscale):
    """The plain branch's histogram in every level mode, linear and
    logarithmic, every display x components x order: the golden render of
    the golden hi_max and levels."""
    rng = np.random.default_rng(len(level))
    counts = rng.integers(0, 900, (3, 256)).astype(np.int32)
    counts[:, :5] = 0
    conf = cfg.HistogramConfig(level_mode=LEVELS[level], level_fixed_value=300,
                               level_ratio_value=2.5, level_height=77)
    for k, (d, n, y) in enumerate(MODES):
        grat = histogram_graticule(3, conf.graticule_horizontal_step, 77, d, n,
                                   conf.level_fixed, conf.level_ratio_permille, logscale)
        sel = ((True, True, True), (True, False, True), (False, False, True))[k % 3]
        job = R.histogram_job(torch.from_numpy(counts), None if grat is None else
                              torch.from_numpy(np.ascontiguousarray(grat)), sel, 131 * 97,
                              conf.level_fixed, conf.level_ratio_permille, logscale, 77, d, n, y)
        _check_job_images([job])


@pytest.mark.parametrize("cs", [1, 2])
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("zoom", [1.0, 1.01, 1.5, 3.0])
def test_plain_vectorscope_equals_golden(cs, white, zoom):
    """The plain branch's vectorscope: the golden render, its graticule
    composited, zoomed about the centre (not at or below 1.01)."""
    counts = np.random.default_rng(cs).integers(0, 256, (256, 256), np.uint8)
    grat = torch.from_numpy(np.ascontiguousarray(vectorscope_graticule(1, False, cs)))
    _check_job_images([R.vectorscope_job(torch.from_numpy(counts), grat, 5, cs, white, zoom)])


def test_cpu_jobs_run_the_plain_chain_and_launch_nothing(monkeypatch):
    """For counts on the CPU the wrapper is the plain version job by job
    and launches nothing; its counter is one of the replays' counters."""
    assert (DRAW, "launches") in _counters()
    jobs = _jobs(monkeypatch=monkeypatch)
    n = DRAW.launches
    got = DRAW(jobs)
    assert DRAW.launches == n
    for job, img in zip(jobs, got):
        assert torch.equal(img, R.draw_stat_plain(job))
    empty = jobs[1]._replace(counts=jobs[1].counts[:, :, :0], graticule=None)
    assert DRAW([empty])[0].shape == (*R.stat_image_shape(empty), 4) == (256, 0, 4)


def _counted(dock, frames):
    profiler.reset()
    profiler.enable(True)
    try:
        frames()
        return profiler.snapshot()
    finally:
        profiler.enable(False)
        profiler.reset()


def test_dock_counts_each_frame_plain_on_the_cpu(monkeypatch):
    """A CPU Dock draws its stats scopes' images in one ``draw_stat_images``
    call a frame, of the three jobs, and launches nothing: every settled
    frame, every skipped frame (interleave 1, the eager composite) and
    every dynamic frame (a drag); a dock with its stats scopes hidden
    builds no job."""
    spy = _Spy(monkeypatch)
    jobs = lambda: [len(c) for c in spy.calls]
    n = DRAW.launches
    dock = _dock()
    _push(dock, 2)
    spy.calls.clear()
    snap = _counted(dock, lambda: _push(dock, 3, seed=5))
    assert sum(s["name"] == "dock.settled" for s in snap["spans"]) == 3
    assert jobs() == [3] * 3

    dock = _dock(interleave=1)
    _push(dock, 2)
    spy.calls.clear()
    snap = _counted(dock, lambda: _push(dock, 4, seed=6))
    assert snap["counters"].get("dock.skipped") == 2
    assert jobs() == [3] * 4

    dock = Dock(DockConfig(), roi=cfg.ROIConfig(interleave=0, target_scale=2, x0=8, y0=4, x1=32,
                                                y1=16), device="cpu")
    _push(dock, 2)
    x0, y0, w, h, _, _ = dock._rects["roi"]
    x, y = x0 + w // 2, y0 + h // 2
    rng = np.random.default_rng(7)

    def drag():
        dock.mouse_move(x, y)
        dock.mouse_down(x, y)
        for k in range(4):
            b = rng.integers(0, 256, (72, 96), dtype=np.uint8)
            dock.mouse_move(x + 2 * (k + 1), y + k + 1)
            m = len(spy.calls)
            dock.push_nv12(b[:48], b[48:])
            dock.render_async()
            assert len(spy.calls) == m + 1

    spy.calls.clear()
    snap = _counted(dock, drag)
    dynamic = sum(s["name"] == "dock.dynamic" for s in snap["spans"])
    assert dynamic == 4 and jobs() == [3] * dynamic

    hidden = Dock(DockConfig(show_vectorscope=False, show_waveform=False, show_histogram=False),
                  roi=cfg.ROIConfig(interleave=0, target_scale=2), device="cpu")
    _push(hidden, 2)
    spy.calls.clear()
    _counted(hidden, lambda: _push(hidden, 2, seed=8))
    assert not any(jobs())
    assert DRAW.launches == n


@pytest.mark.parametrize("interleave", [0, 1])
def test_dock_counts_nothing_when_its_stats_scopes_draw_nothing(interleave, monkeypatch):
    """Stats scopes that are shown but bypassed build no job on their
    settled and skipped frames."""
    off = dict(vectorscope=cfg.VectorscopeConfig(bypass=True),
               waveform=cfg.WaveformConfig(bypass=True),
               histogram=cfg.HistogramConfig(bypass=True))
    dock = _dock(interleave=interleave, **off)
    _push(dock, 2)
    spy = _Spy(monkeypatch)
    snap = _counted(dock, lambda: _push(dock, 4, seed=9))
    assert not any(len(c) for c in spy.calls)
    if interleave:
        assert snap["counters"].get("dock.skipped") == 2


@pytest.mark.parametrize("dynamic_roi", [False, True])
def test_dock_step_says_whether_it_draws(dynamic_roi, monkeypatch):
    """The step's ``_stat_renders`` hands one job a shown stats scope to
    one draw a call, and none when no stats scope is shown."""
    spy = _Spy(monkeypatch)
    rect = (torch.tensor((5, 4, 30, 20), dtype=torch.int32),) if dynamic_roi else ()

    def jobs(**shown):
        make_dock_step(H, W, scale=2, dynamic_roi=dynamic_roi, dock=DockConfig(**shown),
                       device="cpu")(_frame(), 0.5, *rect)
        return len(spy.calls[-1])

    assert jobs() == 3
    assert jobs(show_vectorscope=False, show_waveform=False) == 1
    assert jobs(show_vectorscope=False, show_waveform=False, show_histogram=False) == 0
    assert len(spy.calls) == 3


@pytest.mark.parametrize("logscale", [False, True])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_full_step_draws_its_images_in_one_table(level, logscale, monkeypatch):
    """The full step (``api.make_full_step``) and the batched step draw the
    three images of each frame through one ``draw_stat_images`` call, with
    no graticule, zoom 1 and the scaled frame's pixel count; the images are
    the golden renders of the step's own counts."""
    from obs_color_monitor_tpu_torch import make_batched_step, make_full_step

    calls = []

    def spy(jobs):
        calls.append(list(jobs))
        return DRAW(calls[-1])

    monkeypatch.setattr(R, "draw_stat_images", spy)
    hist = cfg.HistogramConfig(level_mode=LEVELS[level], logscale=logscale,
                               components=cfg.Components.YUV)
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (2, H, W, 4), dtype=np.uint8)
    out = make_full_step(H, W, scale=2, histogram=hist, device="cpu")(
        torch.from_numpy(frames[0]), 0.5)
    assert len(calls) == 1
    jobs = calls[0]
    assert [j.kind for j in jobs] == [R.VECTORSCOPE, R.WAVEFORM, R.HISTOGRAM]
    assert all(j.graticule is None for j in jobs) and jobs[0].zoom == 1.0
    assert int(jobs[2].n_pixels) == SW * SH
    for job, img in zip(jobs, (out.vectorscope, out.waveform, out.histogram)):
        assert np.array_equal(img.numpy(), _golden_image(job)), job.kind
    calls.clear()
    make_batched_step(H, W, scale=2, histogram=hist, device="cpu")(
        torch.from_numpy(frames), torch.tensor([0.5, 1.5]))
    assert len(calls) == 2 and all(len(c) == 3 for c in calls)
