"""The JAX package's own calls with host arrays (numpy frames, numpy
clocks, numpy and JAX rects), run unchanged through the port on the CPU,
each result equal to JAX's bit for bit:

- the steps: the one-program dock (``tests/test_dock_layout.py:119, 146,
  381``), the dynamic dock with a ``jnp`` rect against the static one
  (``tests/test_dynamic_roi.py:162-163, 178``), the NV12 full step
  (``tests/test_fuzz.py:150-173``), the packed u32 frame through the full,
  dock and dynamic steps with a numpy rect and a Dock fed a JAX array
  (``:332-346``), the P010 pairs (``:391-392``), the batched step with a
  host (B,) clock (``tests/test_parallel.py:85-91``, without a mesh) and
  the full step at the odd shapes of ``tests/test_pipeline_kernel.py:36-49``;
- the overlay scopes' ``apply_planes`` on a JAX array
  (``tests/test_overlays_bitexact.py:151-153``);
- every public ``ops`` function whose JAX counterpart takes an array: a
  numpy input equals the tensor input and JAX's output.

The histogram image is held to the golden render of the step's own counts
(which equal JAX's): JAX's render leaves a pixel empty at an exact tie,
``level == threshold * hi_max``, where the spec and the port fill it.  In
a panel the histogram's band is held to the port's same call on a tensor
or an RGBA frame instead, and the rest of the panel to JAX.

Then the captured step's card route, whose buffers are checked here on CPU
tensors: a host argument gets its tensor twin's signature (one graph for
both) and fills its buffer with the same bytes.  And the refusals that
stay: a host frame of the wrong shape, a tensor on another device, what is
not numeric data."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu import config as J
from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.golden import render as grender
from obs_color_monitor_tpu.api import make_batched_step as jax_batched
from obs_color_monitor_tpu.api import make_full_step as jax_full
from obs_color_monitor_tpu.colorspace import Colorspace
from obs_color_monitor_tpu.dock_step import compose_vstack as jax_compose
from obs_color_monitor_tpu.dock_step import make_dock_step as jax_dock
from obs_color_monitor_tpu.models import Dock as JaxDock
from obs_color_monitor_tpu.models import overlays as jmov
from obs_color_monitor_tpu.ops import convert as jconv
from obs_color_monitor_tpu.ops import overlays as jov
from obs_color_monitor_tpu.ops import render as jrender
from obs_color_monitor_tpu.ops import stats as jstats
from obs_color_monitor_tpu.runtime import native as jnative
from obs_color_monitor_tpu_torch import graphs
from obs_color_monitor_tpu_torch import make_batched_step, make_dock_step, make_full_step
from obs_color_monitor_tpu_torch.config import from_reference
from obs_color_monitor_tpu_torch.dock_step import compose_vstack
from obs_color_monitor_tpu_torch.models import Dock
from obs_color_monitor_tpu_torch.models import overlays as tmov
from obs_color_monitor_tpu_torch.ops import convert as tconv
from obs_color_monitor_tpu_torch.ops import overlays as tov
from obs_color_monitor_tpu_torch.ops import render as trender
from obs_color_monitor_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want, what="", skip=()):
    """Every field (or element) of two outputs equal but those in ``skip``:
    same presence, shape and values (compared as int64, or as float64 for
    float arrays; a packed int32 view against JAX's uint32 one by its
    bytes)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        names = getattr(want, "_fields", range(len(want)))
        for name, a, b in zip(names, got, want):
            if name not in skip:
                _equal(a, b, f"{what}.{name}")
        return
    assert (got is None) == (want is None), what
    if want is None:
        return
    a, b = _np(got), np.asarray(want)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if {a.dtype, b.dtype} == {np.dtype(np.int32), np.dtype(np.uint32)}:
        a, b = a.view(np.uint32), b.view(np.uint32)
    kind = np.float64 if b.dtype.kind == "f" else np.int64
    assert np.array_equal(a.astype(kind), b.astype(kind)), what


def _same_dtypes(got, want):
    """The port's fields carry JAX's dtypes."""
    for name, a, b in zip(want._fields, got, want):
        if b is not None:
            assert str(_np(a).dtype) == str(np.asarray(b).dtype), name


def _golden_histogram(hi_counts, h, w, scale, cfg=J.HistogramConfig()):
    """The spec's histogram image of a step's (3, 256) counts."""
    c = cfg.components
    hi = golden.histogram_hi_max(hi_counts, c, w // scale, h // scale, cfg.level_fixed,
                                 cfg.level_ratio_permille)
    levels, eff = golden.histogram_levels(hi_counts, hi, c, cfg.logscale)
    return grender.render_histogram(levels, eff, cfg.level_height, int(cfg.display),
                                    c.n_components, c.is_yuv)


def _equal_scopes(got, want, h, w, scale):
    """A full step's outputs: JAX's fields, the histogram image the
    spec's (a leading batch axis, frame by frame)."""
    _equal(got, want, skip=("histogram",))
    hist, counts = _np(got.histogram), _np(got.hi_counts)
    if counts.ndim == 3:
        for b in range(counts.shape[0]):
            assert np.array_equal(hist[b], _golden_histogram(counts[b], h, w, scale)), b
    else:
        assert np.array_equal(hist, _golden_histogram(counts, h, w, scale))


def _equal_panels(got, want, rects, what=""):
    """Two panels equal outside the histogram's band (``rects`` the
    layout, name -> (x0, y0, w, h, ...))."""
    got, want = _np(got).copy(), np.asarray(want).copy()
    if "histogram" in rects:
        y0, h = rects["histogram"][1], rects["histogram"][3]
        got[y0:y0 + h] = want[y0:y0 + h] = 0
    assert np.array_equal(got, want), what


def _equal_dock(got, want, rects, what=""):
    """A dock step's outputs: JAX's fields, the panel by
    :func:`_equal_panels`."""
    _equal(got, want, what, skip=("panel",))
    _equal_panels(got.panel, want.panel, rects, what)


def _frame(h, w, seed, alpha_holes=False):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = 255
    if alpha_holes:
        f[rng.random((h, w)) < 0.1, 3] = 0
    return f


def _port_kw(kw):
    return {k: from_reference(v) if dataclasses.is_dataclass(v) else v for k, v in kw.items()}


# -- the steps ---------------------------------------------------------------

DOCK_CALLS = {  # tests/test_dock_layout.py: (h, w, make_dock_step keywords)
    "one_program:119": (72, 128, dict(scale=1, out_width=256, out_height=1200)),
    "roi_rect:146": (64, 128, dict(scale=1, out_width=128, out_height=900,
                                   roi_rect=(8, 4, 72, 60))),
    "hidden_scopes:381": (64, 128, dict(scale=1, out_width=128, out_height=800,
                                        dock=J.DockConfig(show_vectorscope=False,
                                                          show_histogram=False))),
}


@pytest.mark.parametrize("call", sorted(DOCK_CALLS))
def test_dock_step_numpy_frame_numpy_clock(call):
    h, w, kw = DOCK_CALLS[call]
    f = _frame(h, w, len(call))
    want = jax_dock(h, w, **kw)(f, np.float32(0.0))
    step = make_dock_step(h, w, **_port_kw(kw), **CPU)
    got = step(f, np.float32(0.0))
    _equal(got, want, call)
    _same_dtypes(got, want)
    _equal(step(torch.from_numpy(f), 0.0), want, call)


RECTS = [(10, 8, 50, 40), (0, 0, 80, 60), (5, 5, 75, 55), (79, 59, 80, 60)]


def test_dynamic_dock_step_jnp_rect():
    """``tests/test_dynamic_roi.py:151-178``: a jnp int32 rect per frame,
    equal to the static build at every rect and to JAX's dynamic step."""
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (120, 160, 4), np.uint8)
    frame[rng.random((120, 160)) < 0.08, 3] = 0
    dk = J.DockConfig(show_roi=False, show_focuspeaking=True)
    kw = dict(scale=2, out_width=128, out_height=672)
    dyn_j = jax_dock(120, 160, dock=dk, dynamic_roi=True, **kw)
    dyn = make_dock_step(120, 160, dock=from_reference(dk), dynamic_roi=True, **kw, **CPU)
    tm = 2.5
    def equal_jax(out, rect):  # the band is held to the static step's above
        _equal_dock(out, dyn_j(frame, np.float32(tm), rect), dyn.rects, str(rect))

    for r in RECTS:
        st = make_dock_step(120, 160, dock=from_reference(dk), roi_rect=r, **kw, **CPU)
        out_s = st(frame, np.float32(tm))
        out_d = dyn(frame, np.float32(tm), jnp.asarray(r, jnp.int32))
        for name in ("vs_counts", "hi_counts", "panel"):
            assert np.array_equal(_np(getattr(out_d, name)), _np(getattr(out_s, name))), (r, name)
        assert np.array_equal(_np(out_d.wv_counts)[:, :, r[0]:r[2]], _np(out_s.wv_counts)), r
        equal_jax(out_d, jnp.asarray(r, jnp.int32))
    for i in range(10):
        rect = jnp.asarray((i, i, 50 + i, 40 + i), jnp.int32)
        equal_jax(dyn(frame, np.float32(tm), rect), rect)


def test_full_step_numpy_nv12_pair():
    """``tests/test_fuzz.py:150-173``: a numpy NV12 pair against the RGBA
    path, and each against JAX."""
    rng = np.random.default_rng(150)
    h, w = 64, 96
    y = rng.integers(16, 236, (h, w), dtype=np.uint8)
    uv = rng.integers(16, 240, (h // 2, w), dtype=np.uint8)
    rgba = jnative.nv12_to_rgba(y, uv, cs=2)
    kw = dict(cs=Colorspace.BT709, scale=1)
    out_nv = make_full_step(h, w, input_format="nv12", **kw, **CPU)((y, uv), np.float32(0.0))
    out_rgba = make_full_step(h, w, **kw, **CPU)(rgba, np.float32(0.0))
    for name in ("vs_counts", "hi_counts", "wv_counts"):
        assert np.array_equal(_np(getattr(out_nv, name)), _np(getattr(out_rgba, name))), name
    _equal_scopes(out_nv, jax_full(h, w, input_format="nv12", **kw)((y, uv), np.float32(0.0)),
                  h, w, 1)
    _equal_scopes(out_rgba, jax_full(h, w, **kw)(rgba, np.float32(0.0)), h, w, 1)


def test_packed_u32_frame_through_every_step():
    """``tests/test_fuzz.py:322-356``: the (H, W) u32 view of a frame
    through the full step, the dock step and the dynamic dock step (a
    numpy int32 rect) equals the RGBA frame there and JAX; a Dock fed the
    view as a JAX array renders the RGBA Dock's panel."""
    rng = np.random.default_rng(332)
    h, w = 48, 64
    rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
    rgba[rng.random((h, w)) < 0.1, 3] = 0
    packed = rgba.view(np.uint32).reshape(h, w)

    kw = dict(cs=Colorspace.BT709, scale=2)
    s1 = make_full_step(h, w, **kw, **CPU)
    s2 = make_full_step(h, w, input_format="packed", **kw, **CPU)
    a, b = s1(rgba, np.float32(1.0)), s2(packed, np.float32(1.0))
    _equal(a, b)
    _equal_scopes(b, jax_full(h, w, input_format="packed", **kw)(packed, np.float32(1.0)),
                  h, w, 2)

    kw = dict(scale=2, out_width=128, out_height=700)
    d1 = make_dock_step(h, w, **kw, **CPU)
    o1, o2 = d1(rgba, np.float32(0.5)), d1(packed, np.float32(0.5))
    assert np.array_equal(_np(o1.panel), _np(o2.panel))
    _equal_dock(o2, jax_dock(h, w, **kw)(packed, np.float32(0.5)), d1.rects)

    kw = dict(scale=1, out_width=128, out_height=700, dynamic_roi=True)
    dd = make_dock_step(h, w, dock=from_reference(J.DockConfig(show_roi=True)), **kw, **CPU)
    r = np.asarray([4, 4, 40, 30], np.int32)
    o3, o4 = dd(rgba, np.float32(0.5), r), dd(packed, np.float32(0.5), r)
    assert np.array_equal(_np(o3.panel), _np(o4.panel))
    _equal_dock(o4, jax_dock(h, w, dock=J.DockConfig(show_roi=True), **kw)(
        packed, np.float32(0.5), r), dd.rects)

    roi = J.ROIConfig(interleave=0, target_scale=1)
    dk1, dk2 = Dock(roi=from_reference(roi), **CPU), Dock(roi=from_reference(roi), **CPU)
    dkj = JaxDock(roi=roi)
    for _ in range(3):
        dk1.push_frame(rgba)
        dk2.push_frame(jnp.asarray(packed))
        dkj.push_frame(jnp.asarray(packed))
        p1, p2 = dk1.render(width=128, height=600), dk2.render(width=128, height=600)
        assert np.array_equal(p1, p2)
    _equal_panels(p2, dkj.render(width=128, height=600), dk2._rects)


@pytest.mark.parametrize("bits,msb", [(10, True), (10, False), (12, False), (14, False),
                                      (16, False)])
def test_full_step_numpy_p010_pair(bits, msb):
    """``tests/test_fuzz.py:361-399``: 16-bit NV12 pairs against the host
    round-shift and the 8-bit path, and against JAX."""
    r = np.random.default_rng(0xF00D + bits + msb)
    h = int(r.choice([32, 48, 62]))
    w = int(r.choice([64, 96, 132]))
    shift = tconv.nv12_shift(bits, msb)
    y16 = r.integers(0, 1 << bits, (h, w)).astype(np.uint16)
    uv16 = r.integers(0, 1 << bits, (h // 2, w)).astype(np.uint16)
    if msb:
        y16 = (y16 << (16 - bits)).astype(np.uint16)
        uv16 = (uv16 << (16 - bits)).astype(np.uint16)

    def to8(a):
        v = (a.astype(np.uint32) + (1 << (shift - 1))) >> shift
        return np.minimum(v, 255).astype(np.uint8)

    kw = dict(cs=Colorspace.BT601, scale=1, input_format="nv12")
    out16 = make_full_step(h, w, nv12_shift=shift, **kw, **CPU)((y16, uv16), np.float32(0.0))
    out8 = make_full_step(h, w, **kw, **CPU)((to8(y16), to8(uv16)), np.float32(0.0))
    for name in ("vs_counts", "wv_counts", "hi_counts"):
        assert np.array_equal(_np(getattr(out16, name)), _np(getattr(out8, name))), name
    _equal_scopes(out16, jax_full(h, w, nv12_shift=shift, **kw)((y16, uv16), np.float32(0.0)),
                  h, w, 1)


@pytest.mark.parametrize("jax_arrays", [False, True])
def test_batched_step_host_clocks(jax_arrays):
    """``tests/test_parallel.py:80-98`` without a mesh: a host batch and a
    host (B,) clock, numpy or JAX, equal to JAX's batched step."""
    rng = np.random.default_rng(85)
    frames = rng.integers(0, 256, (8, 32, 48, 4), dtype=np.uint8)
    frames[..., 3] = 255
    tms = np.arange(8, dtype=np.float32) * 1.5
    kw = dict(cs=Colorspace.BT709, scale=1)
    want = jax_batched(32, 48, **kw)(frames, tms)
    args = (jnp.asarray(frames), jnp.asarray(tms)) if jax_arrays else (frames, tms)
    got = make_batched_step(32, 48, **kw, **CPU)(*args)
    assert got.vs_counts.shape == (8, 256, 256)
    _equal_scopes(got, want, 32, 48, 1)
    _same_dtypes(got, want)


# the odd shapes of tests/test_pipeline_kernel.py:36-49 (h, w, scale)
ODD_SHAPES = [(270, 480, 2), (135, 240, 1), (129, 131, 2), (64, 128, 1), (65, 144, 2),
              (13, 17, 2), (270, 480, 4), (131, 133, 4), (65, 144, 4), (140, 270, 8),
              (131, 270, 8)]


@pytest.mark.parametrize("h,w,scale", ODD_SHAPES)
def test_full_step_numpy_u32_frame_odd_shapes(h, w, scale):
    f = _frame(h, w, h * w, alpha_holes=True)
    packed = f.view(np.uint32)[..., 0]
    kw = dict(cs=Colorspace.BT601, scale=scale, input_format="packed")
    step = make_full_step(h, w, **kw, **CPU)
    got = step(packed, np.float32(3.0))
    _equal(got, step(torch.from_numpy(packed.view(np.int32)), 3.0))
    _equal_scopes(got, jax_full(h, w, **kw)(packed, np.float32(3.0)), h, w, scale)


# -- the models --------------------------------------------------------------

SCOPES = {
    "zebra": (jmov.Zebra, tmov.Zebra, J.ZebraConfig()),
    "falsecolor_key_below": (jmov.FalseColor, tmov.FalseColor,
                             J.FalseColorConfig(show_key=J.ShowKey.BELOW)),
    "focuspeaking": (jmov.FocusPeaking, tmov.FocusPeaking, J.FocusPeakingConfig()),
}


@pytest.mark.parametrize("name", sorted(SCOPES))
def test_apply_planes_jax_array(name):
    """``tests/test_overlays_bitexact.py:151-153``: ``apply_planes`` on a
    JAX array, equal to JAX's."""
    jcls, tcls, cfg = SCOPES[name]
    planes = jnp.asarray(np.random.default_rng(151).integers(0, 256, (4, 40, 64), np.uint8))
    want = jcls(cfg).apply_planes(planes)
    scope = tcls(from_reference(cfg), **CPU)
    got = scope.apply_planes(planes)
    _equal(got, want, name)
    _equal(scope.apply_planes(torch.from_numpy(np.array(planes))), want, name)


# -- the ops functions -------------------------------------------------------


def _ops_inputs():
    f = _frame(24, 40, 9, alpha_holes=True)
    f[:8, :, :3] = np.maximum(f[:8, :, :3], 200)  # the zebra's window
    planes = np.ascontiguousarray(np.moveaxis(f, -1, 0))
    yuv = np.array(jconv.rgb_to_yuv_planes(planes, 2))
    rng = np.random.default_rng(10)
    levels = rng.integers(0, 3000, (3, 256)).astype(np.float32)
    return dict(
        f=f, planes=planes, yuv=yuv, rgb=planes[:3], mask=planes[3] != 0,
        packed=f.view(np.uint32)[..., 0],
        vs=rng.integers(0, 256, (256, 256), np.uint8),
        wv=rng.integers(0, 256, (3, 256, 40), np.uint8),
        counts=rng.integers(0, 500, (3, 256)).astype(np.uint32),
        levels=levels, hi=np.asarray([2999, 1500, 2500], np.float32),
        overlay=rng.integers(0, 256, (24, 40, 4), np.uint8),
        overlay_planes=rng.integers(0, 256, (4, 24, 40), np.uint8),
        lut=rng.integers(0, 256, (40, 4), np.uint8),
        y=rng.integers(0, 256, (24, 40), np.uint8), uv=rng.integers(0, 256, (12, 40), np.uint8),
        y16=rng.integers(0, 1 << 16, (24, 40)).astype(np.uint16),
        uv16=rng.integers(0, 1 << 16, (12, 40)).astype(np.uint16),
    )


SEL = (True, False, True)
PEAK = np.asarray((255, 84, 0, 255), np.uint8)
OPS = {  # name: (port module, JAX module, argument builder from _ops_inputs)
    "convert.planarize": (tconv, jconv, lambda d: (d["f"],)),
    "convert.planarize_packed": (tconv, jconv, lambda d: (d["packed"],)),
    "convert.interleave": (tconv, jconv, lambda d: (d["planes"],)),
    "convert.planes_to_rgba": (tconv, jconv, lambda d: (d["planes"],)),
    "convert.rgb_to_yuv_planes": (tconv, jconv, lambda d: (d["planes"], 1)),
    "convert.rgb_to_yuv_u8": (tconv, jconv, lambda d: (d["f"], 2)),
    "convert.luma_planes": (tconv, jconv, lambda d: (d["planes"], 2)),
    "convert.luma_fixed": (tconv, jconv, lambda d: (d["f"], 1)),
    "convert.downscale_planes": (tconv, jconv, lambda d: (d["planes"], 2)),
    "convert.downscale": (tconv, jconv, lambda d: (d["f"], 3)),
    "convert.roi_crop_planes": (tconv, jconv, lambda d: (d["planes"], 3, 2, 30, 20)),
    "convert.roi_crop": (tconv, jconv, lambda d: (d["f"], 3, 2, 30, 20)),
    "convert.nv12_to_planes": (tconv, jconv, lambda d: (d["y"], d["uv"], 1)),
    "convert.nv12_to_packed": (tconv, jconv, lambda d: (d["y"], d["uv"], 2)),
    "convert.nv12_to_packed p010": (tconv, jconv, lambda d: (d["y16"], d["uv16"], 2, 8)),
    "render.render_vectorscope": (trender, jrender, lambda d: (d["vs"], 3, 2, False)),
    "render.render_waveform": (trender, jrender, lambda d: (d["wv"], 2, 1, 3, False)),
    "render.render_histogram": (trender, jrender, lambda d: (d["levels"], d["hi"], 64, 2, 3,
                                                             True)),
    "render.blend_overlay": (trender, jrender, lambda d: (d["f"], d["overlay"])),
    "render.blend_overlay_planes": (trender, jrender, lambda d: (d["planes"],
                                                                 d["overlay_planes"])),
    "render.zoom_center": (trender, jrender, lambda d: (d["f"], 2.0)),
    "overlays.zebra_planes": (tov, jov, lambda d: (d["planes"], 0.75, 1.0, 4.0, 2)),
    "overlays.zebra": (tov, jov, lambda d: (d["f"], 0.75, 1.0, 4.0, 2)),
    "overlays.falsecolor_planes": (tov, jov, lambda d: (d["planes"], 1)),
    "overlays.falsecolor": (tov, jov, lambda d: (d["f"], 2)),
    "overlays.falsecolor_lut_planes": (tov, jov, lambda d: (d["planes"], d["lut"], 2, 40)),
    "overlays.falsecolor_lut": (tov, jov, lambda d: (d["f"], d["lut"], 2, 40)),
    "overlays.focus_peaking_planes": (tov, jov, lambda d: (d["planes"], 3062, PEAK)),
    "overlays.focus_peaking": (tov, jov, lambda d: (d["f"], 3062, PEAK)),
    "stats.vectorscope_counts_i32": (tstats, jstats, lambda d: (d["yuv"],)),
    "stats.vectorscope_counts": (tstats, jstats, lambda d: (d["yuv"],)),
    "stats.waveform_counts_i32": (tstats, jstats, lambda d: (d["rgb"], d["mask"])),
    "stats.waveform_counts": (tstats, jstats, lambda d: (d["rgb"], d["mask"])),
    "stats.histogram_counts": (tstats, jstats, lambda d: (d["rgb"], d["mask"])),
    "stats.histogram_hi_max": (tstats, jstats, lambda d: (d["counts"], SEL, 960, 0, 0)),
    "stats.histogram_hi_max ratio": (tstats, jstats, lambda d: (d["counts"], SEL, 960, 0, 250)),
    "stats.histogram_levels": (tstats, jstats, lambda d: (d["counts"], d["hi"], SEL, False)),
    "stats.histogram_levels log": (tstats, jstats, lambda d: (d["counts"], d["hi"], SEL, True)),
    "stats.select_planes rgb": (tstats, jstats, lambda d: (d["planes"], None, False)),
    "stats.select_planes yuv": (tstats, jstats, lambda d: (d["planes"], d["yuv"], True)),
    "stats.apply_channel_select": (tstats, jstats, lambda d: (d["wv"], SEL)),
}


def _to_tensors(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32) if a.dtype == np.uint32
                                  else np.ascontiguousarray(a))
                 if isinstance(a, np.ndarray) else a for a in args)


@pytest.mark.parametrize("name", sorted(OPS))
def test_ops_function_takes_numpy(name):
    tmod, jmod, build = OPS[name]
    fn = name.split(".")[1].split()[0]
    args = build(_ops_inputs())
    got = getattr(tmod, fn)(*args)
    want = getattr(jmod, fn)(*args)
    if name == "stats.histogram_levels log":  # float32 log: last-bit differences
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-4)
        _equal(got[1], want[1])
    else:
        _equal(got, want, name)
    _equal(getattr(tmod, fn)(*_to_tensors(args)), got, name)
    _equal(getattr(tmod, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                for a in args)), got, name)


def test_focus_peaking_planes_jnp_rect():
    """``tests/test_dynamic_roi.py:140-143``: a jnp rect covering the frame
    changes nothing."""
    planes = _ops_inputs()["planes"]
    full = tov.focus_peaking_planes(planes, 2000, PEAK)
    rect = tov.focus_peaking_planes(planes, 2000, PEAK, rect=jnp.asarray((0, 0, 40, 24),
                                                                          jnp.int32))
    assert torch.equal(full, rect)
    _equal(full, jov.focus_peaking_planes(planes, 2000, PEAK))


def test_compose_vstack_jax_patches():
    """``tests/test_dock_layout.py:409-427``: JAX patches, overlapping and
    stacked."""
    p1 = jnp.full((4, 6, 4), 10, jnp.uint8)
    p2 = jnp.full((3, 6, 4), 20, jnp.uint8)
    for y2, out_h in ((2, 8), (6, 16)):
        _equal(compose_vstack([(0, 0, p1), (1, y2, p2)], 8, out_h),
               jax_compose([(0, 0, p1), (1, y2, p2)], 8, out_h))


# -- the captured step's card route, on CPU buffers --------------------------


def _twins():
    """(host argument, its tensor twin) pairs a step takes."""
    rng = np.random.default_rng(3)
    f = rng.integers(0, 256, (6, 10, 4), np.uint8)
    u32 = f.view(np.uint32)[..., 0]
    y, uv = rng.integers(0, 256, (6, 10), np.uint8), rng.integers(0, 256, (3, 10), np.uint8)
    p010 = tuple(a.astype(np.uint16) << 6 for a in (y, uv))
    rect = (3, 1, 9, 5)
    t_rect = torch.tensor(rect, dtype=torch.int32)
    return {
        "rgba": (f, torch.from_numpy(f.copy())),
        "rgba jnp": (jnp.asarray(f), torch.from_numpy(f.copy())),
        "packed u32": (u32, torch.from_numpy(u32.view(np.int32).copy())),
        "nv12 pair": ((y, uv), (torch.from_numpy(y), torch.from_numpy(uv))),
        "p010 pair": (p010, tuple(torch.from_numpy(a) for a in p010)),
        "clock np.float32": (np.float32(2.5), torch.tensor(2.5)),
        "clock 0-d": (np.array(2.5, np.float32), torch.tensor(2.5)),
        "clock jnp": (jnp.float32(2.5), torch.tensor(2.5)),
        "clock int": (2, torch.tensor(2.0)),
        "rect numpy": (np.asarray(rect, np.int32), t_rect),
        "rect np.int64 tuple": (tuple(np.int64(v) for v in rect), t_rect),
        "rect jnp": (jnp.asarray(rect, jnp.int32), t_rect),
        "rect int list": (list(rect), t_rect),
        "clocks (B,)": (np.asarray([0.5, 1.5], np.float32), torch.tensor([0.5, 1.5])),
    }


@pytest.mark.parametrize("name", sorted(_twins()))
def test_host_argument_shares_its_twins_graph(name):
    """A host argument's signature is its tensor twin's (one graph for
    both), and it fills the buffer with the same values."""
    host, twin = _twins()[name]
    key = graphs._spec(graphs._host_arg(host))
    assert key == graphs._spec(twin)
    cpu = torch.device("cpu")
    a, b = graphs._buffer(key, cpu), graphs._buffer(key, cpu)
    graphs._fill(a, graphs._host_arg(host), cpu)
    graphs._fill(b, twin, cpu)
    _equal(a, b, name)


def test_host_clock_and_rect_are_filled_not_copied():
    """A host clock and a host rect reach their buffers as kernel arguments
    (``fill_``): no tensor is made from host memory."""
    key = graphs._spec(graphs._host_arg(np.float32(1.0)))
    assert graphs._host_arg(np.float32(1.0)) == 1.0
    assert graphs._host_arg(jnp.asarray((1, 2, 3, 4), jnp.int32)) == (1, 2, 3, 4)
    assert isinstance(graphs._host_arg(np.asarray([0.5, 1.5], np.float32)), np.ndarray)
    assert key == ("t", (), torch.float32)


def test_cpu_step_refusals_stay():
    step = make_full_step(16, 32, input_format="packed", **CPU)
    frame = np.zeros((16, 32), np.uint32)
    with pytest.raises(ValueError):
        step(np.zeros((16, 31), np.uint32), np.float32(0.0))  # a wrong shape
    with pytest.raises(ValueError):
        step(torch.zeros((16, 32), dtype=torch.int32, device="meta"), np.float32(0.0))
    with pytest.raises(TypeError):
        step(np.asarray([["a"] * 32] * 16), 0.0)  # not numeric data
    dock = make_dock_step(16, 32, scale=1, dynamic_roi=True, **CPU)
    with pytest.raises(ValueError):
        dock(np.zeros((16, 30, 4), np.uint8), np.float32(0.0), (0, 0, 4, 4))
    with pytest.raises(ValueError):
        dock(torch.zeros((16, 32, 4), dtype=torch.uint8, device="meta"), 0.0, (0, 0, 4, 4))
    batched = make_batched_step(16, 32, input_format="packed", **CPU)
    with pytest.raises(ValueError):
        batched(np.zeros((2, 16, 32), np.uint32), np.zeros(3, np.float32))  # one clock a frame
    with pytest.raises(ValueError):
        batched(np.zeros((2, 16, 32), np.uint32), np.zeros(2, np.float64))  # float32 clocks
    # the host frame ran on the step's device, and equals the tensor's call
    got = step(frame, np.float32(0.0))
    assert got.vs_counts.device.type == "cpu"
    _equal(got, step(torch.zeros((16, 32), dtype=torch.int32), 0.0))
