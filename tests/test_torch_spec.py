"""The port's own spec modules vs the JAX package's: every constant of
``colorspace``, ``golden`` and the false-colour tables, every config's
default fields, the golden functions on seeded frames, the rasterizer, and
``config.from_reference`` with non-default configs (exact)."""

import dataclasses
import enum
import types

import numpy as np
import pytest

import obs_color_monitor_tpu.colorspace as jcs
import obs_color_monitor_tpu.config as jcfg
import obs_color_monitor_tpu.golden.reference as jref
import obs_color_monitor_tpu.golden.render as jrender
import obs_color_monitor_tpu.utils.draw as jdraw
import obs_color_monitor_tpu_torch.colorspace as tcs
import obs_color_monitor_tpu_torch.config as tcfg
import obs_color_monitor_tpu_torch.golden.reference as tref
import obs_color_monitor_tpu_torch.golden.render as trender
import obs_color_monitor_tpu_torch.utils.draw as tdraw

MODULES = [(jcs, tcs), (jref, tref), (jrender, trender), (jdraw, tdraw)]
CONFIGS = [
    "CaptureConfig", "VectorscopeConfig", "WaveformConfig", "HistogramConfig",
    "ZebraConfig", "FalseColorConfig", "FocusPeakingConfig", "ROIConfig", "DockConfig",
]


def _plain(v):
    """A comparable form of a spec value: enums as ints, arrays as lists."""
    if isinstance(v, enum.Enum):
        return int(v)
    if isinstance(v, np.ndarray):
        return (v.dtype.str, v.tolist())
    if isinstance(v, dict):
        return {_plain(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _constants(mod):
    return {
        k: v for k, v in vars(mod).items()
        if not k.startswith("__")
        and not callable(v)
        and not isinstance(v, (types.ModuleType, type))
        and k != "annotations"
    }


@pytest.mark.parametrize("pair", MODULES, ids=lambda p: p[0].__name__)
def test_module_constants_equal(pair):
    j, t = pair
    jc, tc = _constants(j), _constants(t)
    assert jc.keys() == tc.keys()
    for k in jc:
        assert _plain(jc[k]) == _plain(tc[k]), k


def test_falsecolor_tables_and_enums_equal():
    assert np.array_equal(jref.falsecolor_band_colors_u8(), tref.falsecolor_band_colors_u8())
    assert _plain(jref.FALSECOLOR_BANDS) == _plain(tref.FALSECOLOR_BANDS)
    for name in ("Colorspace",):
        assert [(m.name, int(m)) for m in getattr(jcs, name)] == [
            (m.name, int(m)) for m in getattr(tcs, name)]
    for name in ("Components", "DisplayMode", "LevelMode", "VectorscopeColorType",
                 "GraticuleColor", "ShowKey"):
        assert [(m.name, int(m)) for m in getattr(jcfg, name)] == [
            (m.name, int(m)) for m in getattr(tcfg, name)], name
    for th in (0.0, 0.05, 0.5, 0.75, 1.0):
        assert jref.luma_threshold_fixed(th) == tref.luma_threshold_fixed(th)
        assert jref.peaking_threshold_fixed(max(th, 0.001)) == tref.peaking_threshold_fixed(
            max(th, 0.001))
    for r, g, b in ((255, 84, 0), (0, 0, 0), (191, 0, 191), (17, 200, 99)):
        for cs in (1, 2):
            assert jcs.rgb2uv_int(r, g, b, cs) == tcs.rgb2uv_int(r, g, b, cs)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_defaults_equal(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    for f in dataclasses.fields(j):
        assert _plain(getattr(j, f.name)) == _plain(getattr(t, f.name)), f.name
    for prop in ("th_low", "th_high", "peaking_rgba", "level_fixed", "level_ratio_permille",
                 "graticule_horizontal_step"):
        if hasattr(j, prop):
            assert getattr(j, prop) == getattr(t, prop), prop


def _frame(seed, h=37, w=54):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
    f[::3, :, :3] = np.maximum(f[::3, :, :3], 200)
    return f


GOLDEN_CASES = {
    "rgb_to_yuv_u8": lambda g, f: g.rgb_to_yuv_u8(f, 1),
    "downscale3": lambda g, f: g.downscale(f, 3),
    "downscale2": lambda g, f: g.downscale(f, 2),
    "vectorscope_counts": lambda g, f: g.vectorscope_counts(g.rgb_to_yuv_u8(f, 2)),
    "waveform_rgb": lambda g, f: g.waveform_counts(f, None, 0x07),
    "waveform_yuv": lambda g, f: g.waveform_counts(f, g.rgb_to_yuv_u8(f, 2), 0x70),
    "histogram_uv": lambda g, f: g.histogram_counts(f, g.rgb_to_yuv_u8(f, 1), 0x50),
    "zebra": lambda g, f: g.zebra(f, 0.75, 1.0, 2.5, 2),
    "falsecolor": lambda g, f: g.falsecolor(f, 1),
    "falsecolor_lut": lambda g, f: g.falsecolor(
        f, 2, lut=np.random.default_rng(3).integers(0, 256, (100, 4), np.uint8)),
    "focus_peaking": lambda g, f: g.focus_peaking(f, 0.05, (1.0, 0.33, 0.0, 1.0)),
    "roi_crop": lambda g, f: g.roi_crop(f, 3, 4, 20, 30),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_golden_functions_equal(case):
    fn = GOLDEN_CASES[case]
    for seed in (0, 1):
        f = _frame(seed)
        a, b = fn(jref, f), fn(tref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), case


def test_golden_render_and_canvas_equal():
    counts = np.random.default_rng(2).integers(0, 256, (256, 256), np.uint8)
    assert np.array_equal(jrender.render_vectorscope(counts, 25, 2, False),
                          trender.render_vectorscope(counts, 25, 2, False))
    wv = np.random.default_rng(3).integers(0, 256, (3, 256, 40), np.uint8)
    for display in (0, 1, 2):
        assert np.array_equal(jrender.render_waveform(wv, 51, display, 3, True),
                              trender.render_waveform(wv, 51, display, 3, True))
    drawn = []
    for mod in (jdraw, tdraw):
        c = mod.OverlayCanvas(40, 60)
        c.line(1.5, 2.0, 50.0, 33.0, (255, 191, 0, 128))
        c.text("R Cy 10", 3, 20, (0, 255, 0, 128))
        c.rect_fill(5.0, 5.0, 30.0, 12.0, (0, 0, 0, 128))
        drawn.append(mod.alpha_blend_u8(np.full((40, 60, 4), 77, np.uint8), c.rgba))
    assert np.array_equal(*drawn)
    assert np.array_equal(jdraw.text_mask("0123456789", 2), tdraw.text_mask("0123456789", 2))


def _non_default_configs():
    lut = np.random.default_rng(4).integers(0, 256, (64, 4), np.uint8)
    return [
        jcfg.VectorscopeConfig(intensity=80, color_type=0, graticule=jcfg.GraticuleColor.GREEN,
                               zoom=2.5, target_scale=3, colorspace=1),
        jcfg.WaveformConfig(display=jcfg.DisplayMode.PARADE, components=jcfg.Components.YUV,
                            intensity=90, graticule_lines=10),
        jcfg.HistogramConfig(display=jcfg.DisplayMode.STACK, components=jcfg.Components.UV,
                             level_mode=jcfg.LevelMode.PIXEL, level_fixed_value=3000,
                             graticule_horizontal_step_fixed=500.0, logscale=True),
        jcfg.ZebraConfig(zebra_th_low=60, zebra_th_high=95, colorspace=1),
        jcfg.FalseColorConfig(use_lut=True, lut=lut, show_key=jcfg.ShowKey.OUTSIDE),
        jcfg.FocusPeakingConfig(peaking_color=0xFF00FF00, peaking_threshold=0.02,
                                actual_size=True),
        jcfg.ROIConfig(interleave=0, x0=4, y0=5, x1=60, y1=40),
        jcfg.DockConfig(show_roi=False, show_focuspeaking=True, width=300, height=700),
    ]


@pytest.mark.parametrize("cfg", _non_default_configs(), ids=lambda c: type(c).__name__)
def test_from_reference_round_trip(cfg):
    got = tcfg.from_reference(cfg)
    assert type(got) is getattr(tcfg, type(cfg).__name__)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(got, f.name)
        assert _plain(a) == _plain(b), f.name
        if isinstance(a, enum.Enum):
            assert type(b) is getattr(tcfg, type(a).__name__, None) or type(b) is getattr(
                tcs, type(a).__name__), f.name
    if isinstance(cfg, jcfg.FalseColorConfig):
        assert got.lut is not cfg.lut and got.lut.dtype == np.uint8
    again = tcfg.from_reference(got)  # the port's own configs pass as well
    assert _plain(dataclasses.asdict(again)) == _plain(dataclasses.asdict(got))


def test_from_reference_rejects_unknown_objects():
    with pytest.raises(TypeError, match="no port config"):
        tcfg.from_reference(object())

    @dataclasses.dataclass
    class DockConfig:  # same name, missing fields
        show_roi: bool = True

    with pytest.raises(TypeError, match="has no field"):
        tcfg.from_reference(DockConfig())


# ---------------------------------------------------------------------------
# the host pipeline's copies: locales, native runtime, PNG, sinks, settings
# ---------------------------------------------------------------------------

LOCALES = ("de-DE", "en-US", "fr-FR", "ja-JP", "pt-BR", "zh-CN")


@pytest.mark.parametrize("tag", LOCALES)
def test_locale_tables_equal(tag):
    """The port's own locale JSON files equal the JAX package's, key for
    key, and the port reads its own directory."""
    import json
    from pathlib import Path

    import obs_color_monitor_tpu.utils.i18n as ji18n
    import obs_color_monitor_tpu_torch.utils.i18n as ti18n

    jdir = Path(ji18n.__file__).resolve().parents[1] / "data" / "locale"
    tdir = Path(ti18n._LOCALE_DIR)
    assert tdir == Path(ti18n.__file__).resolve().parents[1] / "data" / "locale"
    assert "obs_color_monitor_tpu_torch" in tdir.parts
    jt = json.loads((jdir / f"{tag}.json").read_text(encoding="utf-8"))
    tt = json.loads((tdir / f"{tag}.json").read_text(encoding="utf-8"))
    assert list(jt.items()) == list(tt.items())
    assert ji18n._EN_US == ti18n._EN_US
    ti18n.set_locale(tag)
    try:
        assert {k: ti18n.text(k) for k in jt} == {k: jt[k] for k in jt}
    finally:
        ti18n.set_locale("en-US")


def test_native_constants_equal():
    import obs_color_monitor_tpu.runtime.native as jn
    import obs_color_monitor_tpu_torch.runtime.native as tn

    assert jn._NV12_COEF == tn._NV12_COEF and jn._KY == tn._KY
    assert (jn.NativeFileReader.FORMAT_RGBA, jn.NativeFileReader.FORMAT_NV12) == (
        tn.NativeFileReader.FORMAT_RGBA, tn.NativeFileReader.FORMAT_NV12)
    assert tn._SRC == jn._SRC  # the one C++ source at the repository root
    assert "obs_color_monitor_tpu_torch" in tn._LIB_DIR.parts


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_native_outputs_equal(route, monkeypatch):
    """nv12_to_rgba, yuv_planes_to_rgba, deinterleave_rgba and pattern of
    the port's runtime equal the JAX package's, through the C++ library and
    through the NumPy fallback."""
    import obs_color_monitor_tpu.runtime.native as jn
    import obs_color_monitor_tpu_torch.runtime.native as tn

    if route == "numpy":
        monkeypatch.setattr(tn, "_load", lambda: None)
    else:
        assert tn.available()
    rng = np.random.default_rng(11)
    y = rng.integers(0, 256, (10, 14), np.uint8)
    uv = rng.integers(0, 256, (5, 14), np.uint8)
    for cs in (1, 2):
        assert np.array_equal(tn.nv12_to_rgba(y, uv, cs), jn.nv12_to_rgba(y, uv, cs))
        c = rng.integers(0, 256, (10, 7), np.uint8)
        assert np.array_equal(tn.yuv_planes_to_rgba(y, c, c, cs),
                              jn.yuv_planes_to_rgba(y, c, c, cs))
    f = rng.integers(0, 256, (6, 9, 4), np.uint8)
    assert np.array_equal(tn.deinterleave_rgba(f), jn.deinterleave_rgba(f))
    for kind in ("bars", "ramp", "zoneplate"):
        for i in (0, 7):
            assert np.array_equal(tn.pattern(kind, 40, 24, i), jn.pattern(kind, 40, 24, i)), kind


def test_encode_png_bytes_equal():
    import obs_color_monitor_tpu.utils.image_io as jio
    import obs_color_monitor_tpu_torch.utils.image_io as tio

    rng = np.random.default_rng(5)
    for shape in ((7, 11, 4), (3, 5, 3), (1, 1, 4)):
        img = rng.integers(0, 256, shape, np.uint8)
        assert tio.encode_png(img) == jio.encode_png(img)


def test_rgb_to_yuv_limited_equal():
    import obs_color_monitor_tpu.pipeline.sinks as js
    import obs_color_monitor_tpu_torch.pipeline.sinks as ts

    assert js._FWD == ts._FWD and js._FFMPEG_CS == ts._FFMPEG_CS
    f = np.random.default_rng(6).integers(0, 256, (9, 13, 4), np.uint8)
    for cs in (1, 2):
        for a, b in zip(js.rgb_to_yuv_limited(f, cs), ts.rgb_to_yuv_limited(f, cs)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert js.ffmpeg_sink_cmd("o.mp4", 33, 17, 29.97, cs=1) == ts.ffmpeg_sink_cmd(
        "o.mp4", 33, 17, 29.97, cs=1)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_to_dict_equal(name):
    """persistence.config_to_dict of every config, at its defaults and
    with every field set through config_from_dict from the JAX dict."""
    import json

    import obs_color_monitor_tpu.utils.persistence as jp
    import obs_color_monitor_tpu_torch.utils.persistence as tp

    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert json.dumps(jp.config_to_dict(j)) == json.dumps(tp.config_to_dict(t))
    d = json.loads(json.dumps(jp.config_to_dict(j)))
    assert tp.config_to_dict(tp.config_from_dict(getattr(tcfg, name), d)) == d
