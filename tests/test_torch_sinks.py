"""The port's video sinks, settings persistence, locales and source
registry on the CPU (``obs_color_monitor_tpu_torch.pipeline.sinks``,
``utils.{persistence, i18n, image_io}``, ``registry``).

The non-CLI cases of ``tests/test_sinks.py``, ``tests/test_persistence_cli.py``
and ``tests/test_registry.py`` run on the port (the CLI cases are in
``tests/test_torch_cli.py``), with the same skips; then settings written by
one package load into the other with equal configs, and the registry's
inventory equals the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu import config as J
from obs_color_monitor_tpu import models as jm
from obs_color_monitor_tpu import registry as jreg
from obs_color_monitor_tpu.utils import persistence as jpers
from obs_color_monitor_tpu_torch.config import (
    Components,
    DisplayMode,
    FalseColorConfig,
    ROIConfig,
    ShowKey,
    VectorscopeConfig,
    VectorscopeColorType,
)
from obs_color_monitor_tpu_torch.models import Dock
from obs_color_monitor_tpu_torch.pipeline.ingest import Y4MSource
from obs_color_monitor_tpu_torch.pipeline.sinks import (
    _FWD,
    FFmpegSink,
    RecordingTee,
    Y4MSink,
    ffmpeg_sink_cmd,
    open_video_sink,
    rgb_to_yuv_limited,
)
from obs_color_monitor_tpu_torch.registry import REGISTRY, create_source, enum_sources
from obs_color_monitor_tpu_torch.utils import persistence as tpers
from obs_color_monitor_tpu_torch.utils.image_io import write_png
from obs_color_monitor_tpu_torch.utils.persistence import (
    GlobalConfig,
    config_from_dict,
    config_to_dict,
    dock_save_data,
    load_dock,
    save_dock,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# forward conversion
# ---------------------------------------------------------------------------


def test_forward_matrix_rows():
    """Chroma rows sum to 0 (gray -> exactly 128) and Y rows to
    round(219/255 * 4096) = 3518, the inverse of the decoder's ky=4769."""
    for cs, (ky, kcb, kcr) in _FWD.items():
        assert sum(kcb) == 0 and sum(kcr) == 0, cs
        assert sum(ky) == 3518, cs


@pytest.mark.parametrize("cs", [1, 2])
def test_gray_maps_to_neutral_chroma(cs):
    frame = np.full((4, 8, 4), 0, np.uint8)
    for i, v in enumerate((0, 77, 128, 255)):
        frame[i] = v
    y, u, v = rgb_to_yuv_limited(frame, cs=cs)
    np.testing.assert_array_equal(u, 128)
    np.testing.assert_array_equal(v, 128)
    # black row -> Y=16, white row -> Y=235 (studio range endpoints)
    assert y[0].max() == 16 and y[3].min() == 235


def test_forward_studio_range(rng):
    frame = rng.integers(0, 256, (32, 48, 4), np.uint8)
    y, u, v = rgb_to_yuv_limited(frame, cs=2)
    assert y.min() >= 16 and y.max() <= 235
    assert u.min() >= 16 and u.max() <= 240
    assert v.min() >= 16 and v.max() <= 240


def test_forward_rejects_bad_cs():
    with pytest.raises(ValueError):
        rgb_to_yuv_limited(np.zeros((2, 2, 4), np.uint8), cs=0)


# ---------------------------------------------------------------------------
# Y4M sink
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cs", [1, 2])
def test_y4m_roundtrip(tmp_path, rng, cs):
    """write -> read reproduces the input to within limited-range
    quantization (C444 keeps the sink spatially lossless, so the only
    loss is the 219/224-step level quantization both ways)."""
    w, h = 33, 17  # odd dims: C444 has no subsampling constraint
    frames = [rng.integers(0, 256, (h, w, 4), np.uint8) for _ in range(3)]
    p = tmp_path / "rec.y4m"
    with Y4MSink(str(p), w, h, fps=29.97, cs=cs) as sink:
        for f in frames:
            sink.write(f)
    assert sink.n_written == 3

    src = Y4MSource(str(p), cs=cs)
    assert (src.width, src.height) == (w, h)
    back = list(src.frames())
    assert len(back) == 3
    for f, b in zip(frames, back):
        err = np.abs(f[..., :3].astype(int) - b[..., :3].astype(int))
        assert err.max() <= 4, err.max()
        assert err.mean() < 1.5
        np.testing.assert_array_equal(b[..., 3], 255)


def test_y4m_header_fraction_fps(tmp_path):
    p = tmp_path / "r.y4m"
    Y4MSink(str(p), 8, 4, fps=23.976).close()
    hdr = open(p, "rb").readline().decode()
    assert hdr.startswith("YUV4MPEG2 W8 H4 F")
    num, den = hdr.split(" F")[1].split()[0].split(":")
    assert abs(int(num) / int(den) - 23.976) < 1e-3
    assert " C444" in hdr


def test_y4m_sink_rejects_wrong_geometry(tmp_path):
    with Y4MSink(str(tmp_path / "r.y4m"), 8, 4) as sink:
        with pytest.raises(ValueError):
            sink.write(np.zeros((5, 8, 4), np.uint8))
        with pytest.raises(ValueError):
            sink.write(np.zeros((4, 8, 4), np.float32))
    with pytest.raises(ValueError):
        Y4MSink(str(tmp_path / "r2.y4m"), 0, 4)
    with pytest.raises(ValueError):
        Y4MSink(str(tmp_path / "r3.y4m"), 8, 4, cs=3)


def test_y4m_accepts_rgb_without_alpha(tmp_path, rng):
    p = tmp_path / "rgb.y4m"
    f = rng.integers(0, 256, (4, 8, 3), np.uint8)
    with Y4MSink(str(p), 8, 4) as sink:
        sink.write(f)
    (back,) = Y4MSource(str(p), cs=2).frames()
    assert back.shape == (4, 8, 4)


# ---------------------------------------------------------------------------
# ffmpeg sink gate / dispatch
# ---------------------------------------------------------------------------


def _have_ffmpeg():
    import shutil

    return shutil.which("ffmpeg") is not None


def test_open_video_sink_dispatch(tmp_path):
    s = open_video_sink(str(tmp_path / "a.y4m"), 8, 4)
    assert isinstance(s, Y4MSink)
    s.close()
    if not _have_ffmpeg():
        with pytest.raises(RuntimeError, match="ffmpeg"):
            open_video_sink(str(tmp_path / "a.mp4"), 8, 4)


@pytest.mark.skipif(not _have_ffmpeg(), reason="no system ffmpeg")
def test_ffmpeg_sink_encodes(tmp_path, rng):
    p = tmp_path / "a.mp4"
    with FFmpegSink(str(p), 32, 16, fps=30.0) as sink:
        for _ in range(4):
            sink.write(rng.integers(0, 256, (16, 32, 4), np.uint8))
    assert p.stat().st_size > 0


def test_ffmpeg_cmd_pins_output_format():
    """For rgba input libx264 would pick yuv444p (High 4:4:4 — refused by
    most players/hardware decoders); the sink always pins yuv420p (odd
    dims are padded to even in the filter chain) and tags/converts with
    the cs the caller asked for."""
    cmd = ffmpeg_sink_cmd("o.mp4", 128, 64, 30.0, cs=2)
    assert cmd[cmd.index("-pix_fmt", cmd.index("pipe:0")) + 1] == "yuv420p"
    assert cmd[cmd.index("-colorspace") + 1] == "bt709"
    assert "scale=out_color_matrix=bt709:out_range=tv" in cmd
    # even dims: no pad stage in the filter chain
    assert "pad=" not in cmd[cmd.index("-vf") + 1]
    # BT.601 tags
    cmd601 = ffmpeg_sink_cmd("o.mp4", 128, 64, 30.0, cs=1)
    assert cmd601[cmd601.index("-colorspace") + 1] == "smpte170m"
    # odd dims: padded to even so yuv420p is still pinned
    codd = ffmpeg_sink_cmd("o.mp4", 33, 17, 30.0)
    assert codd[codd.index("-pix_fmt", codd.index("pipe:0")) + 1] == "yuv420p"
    assert "pad=ceil(iw/2)*2:ceil(ih/2)*2" in codd[codd.index("-vf") + 1]
    # caller overrides come last so they win
    cx = ffmpeg_sink_cmd("o.mp4", 128, 64, 30.0, extra_args=["-pix_fmt", "yuv422p"])
    last = max(i for i, a in enumerate(cx) if a == "-pix_fmt")
    assert cx[last + 1] == "yuv422p"


# ---------------------------------------------------------------------------
# recording tee
# ---------------------------------------------------------------------------


def test_y4m_source_parses_fps(tmp_path):
    p = tmp_path / "r.y4m"
    Y4MSink(str(p), 8, 4, fps=60.0).close()
    assert Y4MSource(str(p), cs=2).fps == 60.0


def test_recording_tee_source_rate(tmp_path, capsys):
    """The tee labels the recording at the SOURCE's rate (a 60 fps input
    must not come back labeled 30 fps), unless --fps overrides."""
    src_p = tmp_path / "in.y4m"
    Y4MSink(str(src_p), 8, 4, fps=60.0).close()
    src = Y4MSource(str(src_p), cs=2)

    rec = tmp_path / "rec.y4m"
    tee = RecordingTee(str(rec), 0.0, src, cs=2)
    assert tee.fps == 60.0
    tee.write(np.zeros((4, 8, 4), np.uint8))
    tee.close()
    assert "video: 1 frames" in capsys.readouterr().out
    assert Y4MSource(str(rec), cs=2).fps == 60.0
    # explicit --fps wins over the source rate
    assert RecordingTee(str(rec), 24.0, src, cs=2).fps == 24.0
    # sources without a rate fall back to 30
    assert RecordingTee(str(rec), 0.0, object(), cs=2).fps == 30.0


def test_recording_tee_close_error_modes(tmp_path, monkeypatch, capsys):
    """close(raise_errors=False) downgrades a failing sink close to a
    stderr note (finally-block semantics: never mask the loop's own
    exception); raise_errors=True propagates it."""
    from obs_color_monitor_tpu_torch.pipeline import sinks as sinks_mod

    class BoomSink:
        n_written = 0

        def write(self, img):
            self.n_written += 1

        def close(self):
            raise RuntimeError("ffmpeg exited with status 1")

    monkeypatch.setattr(
        sinks_mod, "open_video_sink", lambda *a, **k: BoomSink()
    )
    tee = RecordingTee(str(tmp_path / "x.mp4"), 30.0, None, cs=2)
    tee.write(np.zeros((4, 8, 4), np.uint8))
    tee.close(raise_errors=False)  # must not raise
    assert "video sink close failed" in capsys.readouterr().err
    tee2 = RecordingTee(str(tmp_path / "y.mp4"), 30.0, None, cs=2)
    tee2.write(np.zeros((4, 8, 4), np.uint8))
    with pytest.raises(RuntimeError, match="ffmpeg exited"):
        tee2.close()
    # closing an never-opened tee is a no-op
    RecordingTee(str(tmp_path / "z.mp4"), 30.0, None, cs=2).close()


# ---------------------------------------------------------------------------
# persistence, image IO, locales (tests/test_persistence_cli.py)
# ---------------------------------------------------------------------------


def test_config_roundtrip():
    cfg = VectorscopeConfig(intensity=77, zoom=2.5, colorspace=1)
    d = config_to_dict(cfg)
    back = config_from_dict(VectorscopeConfig, d)
    assert back == cfg
    # enums serialized as ints (JSON-safe)
    assert json.dumps(d)


def test_falsecolor_lut_roundtrip(rng):
    lut = rng.integers(0, 256, (16, 4), dtype=np.uint8)
    cfg = FalseColorConfig(use_lut=True, lut=lut, show_key=ShowKey.LEFT)
    d = json.loads(json.dumps(config_to_dict(cfg)))
    back = config_from_dict(FalseColorConfig, d)
    np.testing.assert_array_equal(back.lut, lut)
    assert back.show_key == ShowKey.LEFT


def test_dock_save_load(tmp_path):
    dock = Dock(roi=ROIConfig(target_scale=4, interleave=0), device="cpu")
    dock.config.show_zebra = False
    dock.waveform.update(display=DisplayMode.PARADE, components=Components.YUV)
    dock.vectorscope.update(intensity=99)
    p = tmp_path / "dock.json"
    save_dock(dock, p)

    dock2 = Dock(device="cpu")
    load_dock(dock2, p)
    assert dock2.hub.config.target_scale == 4
    assert dock2.config.show_zebra is False
    assert dock2.waveform.config.display == DisplayMode.PARADE
    assert dock2.waveform.config.components == Components.YUV
    assert dock2.vectorscope.config.intensity == 99
    # key scheme mirrors the reference ("<id>-shown"/"<id>-prop")
    data = dock_save_data(dock)
    assert "vectorscope-shown" in data and "waveform-prop" in data


def test_global_config(tmp_path):
    p = tmp_path / "global.json"
    g = GlobalConfig(show_sources=False)
    g.save(p)
    g2 = GlobalConfig.load(p)
    assert g2.show_sources is False and g2.show_filters is True
    assert GlobalConfig.load(tmp_path / "missing.json").show_sources is True


def test_write_png_fallback(tmp_path, rng):
    img = rng.integers(0, 256, (8, 12, 4), dtype=np.uint8)
    p = tmp_path / "t.png"
    write_png(p, img)
    raw = p.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    # round-trip via PIL when available
    try:
        from PIL import Image

        back = np.asarray(Image.open(p).convert("RGBA"))
        np.testing.assert_array_equal(back, img)
    except ImportError:
        pass


def test_i18n():
    from obs_color_monitor_tpu_torch.utils.i18n import get_locale, set_locale, text

    assert text("FocusPeaking.Name") == "Focus Peaking"
    assert text("missing.key") == "missing.key"
    set_locale("de-DE")
    try:
        assert get_locale() == "de-DE"
        assert text("Waveform") == "Wellenform"
        assert text("False Color") == "Falschfarben"
        assert text("missing.key") == "missing.key"  # falls back to the key
    finally:
        set_locale("en-US")


def test_i18n_reference_locales_complete():
    """Every key of the reference's en-US.ini resolves in all 5 languages
    (reference data/locale/{en-US,fr-FR,ja-JP,pt-BR,zh-CN}.ini, 91 keys)."""
    import json
    from pathlib import Path

    from obs_color_monitor_tpu_torch.utils import i18n

    locale_dir = Path(i18n.__file__).resolve().parents[1] / "data" / "locale"
    en_keys = set(json.loads((locale_dir / "en-US.json").read_text()))
    assert len(en_keys) == 91
    assert en_keys == set(i18n._EN_US)  # builtin covers the full key set
    for tag in ("fr-FR", "ja-JP", "pt-BR", "zh-CN", "de-DE"):
        table = json.loads((locale_dir / f"{tag}.json").read_text(encoding="utf-8"))
        assert set(table) == en_keys, f"{tag} key set diverges"
        i18n.set_locale(tag)
        try:
            for k in en_keys:
                assert i18n.text(k)  # resolves, non-empty
            # spot-check a translation actually differs from the key
            # (pt-BR keeps "Vectorscope" untranslated in the reference)
            assert i18n.text("Interleave") != "Interleave"
        finally:
            i18n.set_locale("en-US")


def test_dock_manager(tmp_path):
    from obs_color_monitor_tpu_torch.utils.persistence import DockManager

    mgr = DockManager()
    d1 = Dock(device="cpu")
    d1.vectorscope.update(intensity=42)
    mgr.add("main", d1)
    blob = mgr.save_all()

    mgr2 = DockManager()
    mgr2.load_all(blob, make_dock=lambda: Dock(device="cpu"))
    assert mgr2.docks["main"].vectorscope.config.intensity == 42
    with pytest.raises(KeyError):
        mgr.add("main", Dock(device="cpu"))


# ---------------------------------------------------------------------------
# registry (tests/test_registry.py)
# ---------------------------------------------------------------------------


def test_registry_inventory():
    """11 registered infos like obs_module_load (src/plugin-main.c:58-108)."""
    assert len(REGISTRY) == 11
    assert sorted(s for s in REGISTRY if REGISTRY[s].kind == "filter") == [
        "falsecolor_filter",
        "focuspeaking_filter",
        "zebra_filter",
    ]
    # v1 is registered but obsolete (reference OBS_SOURCE_CAP_OBSOLETE,
    # src/vectorscope.c:487)
    assert REGISTRY["vectorscope_source"].obsolete
    assert not REGISTRY["vectorscope_source.v2"].obsolete


def test_v1_v2_defaults():
    """v1 defaults to white draw, v2 to chroma tint
    (reference vss_get_defaults_v1 vs vss_get_defaults,
    src/vectorscope.c:155-167)."""
    v1 = create_source("vectorscope_source", device="cpu")
    v2 = create_source("vectorscope_source.v2", device="cpu")
    assert v1.config.color_type == VectorscopeColorType.WHITE
    assert v2.config.color_type == VectorscopeColorType.UV


def test_global_config_gates():
    g = GlobalConfig(show_sources=False)
    with pytest.raises(PermissionError):
        create_source("waveform_source", global_config=g, device="cpu")
    # filters still allowed
    create_source("zebra_filter", global_config=g, device="cpu")
    g2 = GlobalConfig(show_filters=False)
    with pytest.raises(PermissionError):
        create_source("zebra_filter", global_config=g2, device="cpu")


def test_enum_sources():
    srcs = enum_sources("source")
    assert "vectorscope_source.v2" in srcs
    assert "vectorscope_source" not in srcs  # obsolete hidden by default
    assert "zebra_filter" not in srcs
    assert "vectorscope_source" in enum_sources("source", include_obsolete=True)


def test_created_source_works():
    his = create_source("histogram_source", device="cpu")
    f = np.zeros((32, 32, 4), np.uint8)
    f[..., 3] = 255
    his.push_frame(f)
    assert his.counts() is not None

def test_dock_default_shown_flags():
    """A fresh dock mirrors ScopeWidget::default_properties (reference
    src/scope-widget.cpp:496-506): every source's "-shown" defaults true
    EXCEPT focus peaking, which the loop explicitly skips."""
    from obs_color_monitor_tpu_torch.config import DockConfig

    dk = DockConfig()
    assert dk.show_roi
    assert dk.show_vectorscope
    assert dk.show_waveform
    assert dk.show_histogram
    assert dk.show_zebra
    assert dk.show_falsecolor
    assert not dk.show_focuspeaking


def test_histogram_graticule_property_model():
    """The histogram keeps TWO horizontal-step settings and applies the one
    matching the level mode (reference src/histogram.c:137-151); the
    vertical-lines combo offers {0,1,2,4,5,10} (src/histogram.c:274-281)."""
    from obs_color_monitor_tpu_torch.config import HistogramConfig, LevelMode

    c = HistogramConfig(
        level_mode=LevelMode.PIXEL,
        graticule_horizontal_step_fixed=200.0,
        graticule_horizontal_step_ratio=5.0,
    )
    assert c.graticule_horizontal_step == 200.0
    c.level_mode = LevelMode.RATIO
    assert c.graticule_horizontal_step == 5.0
    c.level_mode = LevelMode.AUTO  # never loads a step -> no H lines
    assert c.graticule_horizontal_step == -1.0
    # combo snapping, same list as the waveform's graticule_lines
    assert HistogramConfig(graticule_vertical_lines=3).graticule_vertical_lines in (2, 4)
    assert HistogramConfig(graticule_vertical_lines=7).graticule_vertical_lines == 5
    assert HistogramConfig(graticule_vertical_lines=100).graticule_vertical_lines == 10


def test_histogram_graticule_legacy_alias():
    """The pre-split single ``graticule_horizontal_step`` name still works:
    as a Scope.update setting and through saved-dock JSON (it writes BOTH
    mode-paired fields); read-only derived properties raise the same
    KeyError as unknown settings."""
    import pytest

    from obs_color_monitor_tpu_torch.config import HistogramConfig, LevelMode
    from obs_color_monitor_tpu_torch.models import Histogram
    from obs_color_monitor_tpu_torch.utils.persistence import config_from_dict

    h = Histogram(HistogramConfig(level_mode=LevelMode.PIXEL), device="cpu")
    h.update(graticule_horizontal_step=100.0)
    assert h.config.graticule_horizontal_step_fixed == 100.0
    assert h.config.graticule_horizontal_step_ratio == 100.0
    assert h.config.graticule_horizontal_step == 100.0

    with pytest.raises(KeyError):
        h.update(level_fixed=123)  # read-only derived property
    with pytest.raises(KeyError):
        h.update(no_such_setting=1)

    # old saved dock JSON (pre-split field name) keeps its H graticule
    c = config_from_dict(
        HistogramConfig,
        {"level_mode": int(LevelMode.RATIO), "graticule_horizontal_step": 20.0},
    )
    assert c.graticule_horizontal_step == 20.0
    assert c.graticule_horizontal_step_fixed == 20.0


def test_config_key_generation_memoization():
    """config_key is memoized per config GENERATION: steady-state stream
    revalidation is O(1) dict probes, while any field assignment (update()
    or direct attribute set) bumps the generation and re-derives."""
    import dataclasses

    from obs_color_monitor_tpu_torch.config import WaveformConfig, config_key

    c = WaveformConfig()
    k1 = config_key(c)
    assert config_key(c) is k1  # cache hit returns the same tuple object
    c.intensity = 99  # direct field assignment bumps the generation
    k2 = config_key(c)
    assert k2 is not k1 and k2 != k1
    assert config_key(c) is k2
    # skip variants cache independently under one generation
    ks = config_key(c, skip=("intensity",))
    assert ks != k2
    assert config_key(c, skip=("intensity",)) is ks
    # value identity: an equal-valued fresh config derives an equal key
    assert config_key(WaveformConfig(intensity=99)) == k2
    # bookkeeping attributes are not dataclass fields (persistence walks
    # dataclasses.fields and must never see them)
    assert "_gen" not in {f.name for f in dataclasses.fields(c)}


# ---------------------------------------------------------------------------
# settings carried across the two packages
# ---------------------------------------------------------------------------


def _nondefault_jax_dock():
    d = jm.Dock(roi=J.ROIConfig(target_scale=3, interleave=2, x0=4, y0=2, x1=40, y1=30))
    d.config.show_zebra = False
    d.config.show_focuspeaking = True
    d.config.height = 900
    d.waveform.update(display=J.DisplayMode.PARADE, components=J.Components.YUV)
    d.vectorscope.update(intensity=99, zoom=2.0, colorspace=1)
    d.histogram.update(level_mode=J.LevelMode.RATIO, logscale=True)
    d.falsecolor.update(use_lut=True, lut=np.arange(64, dtype=np.uint8).reshape(16, 4),
                        show_key=J.ShowKey.LEFT)
    d.focuspeaking.update(peaking_threshold=0.03, actual_size=True)
    return d


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_settings_cross_load(tmp_path, direction):
    """A dock settings file saved by one package loads into a fresh dock of
    the other with equal save data: every config, every shown flag."""
    jd = _nondefault_jax_dock()
    p = tmp_path / "dock.json"
    if direction == "jax_to_port":
        jpers.save_dock(jd, p)
        td = Dock(device="cpu")
        tpers.load_dock(td, p)
        got, want = tpers.dock_save_data(td), jpers.dock_save_data(jd)
    else:
        jpers.save_dock(jd, p)
        td = Dock(device="cpu")
        tpers.load_dock(td, p)  # the port dock now holds the JAX settings
        p2 = tmp_path / "port.json"
        tpers.save_dock(td, p2)
        jd2 = jm.Dock()
        jpers.load_dock(jd2, p2)
        got, want = jpers.dock_save_data(jd2), jpers.dock_save_data(jd)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got["falsecolor-prop"]["lut"] == np.arange(64).reshape(16, 4).tolist()


def test_dock_manager_cross_load():
    """DockManager.save_all from JAX loads through the port's load_all."""
    mgr = jpers.DockManager()
    mgr.add("main", _nondefault_jax_dock())
    blob = json.loads(json.dumps(mgr.save_all()))
    tmgr = tpers.DockManager()
    tmgr.load_all(blob, make_dock=lambda: Dock(device="cpu"))
    assert json.loads(json.dumps(tmgr.save_all())) == blob


def test_global_config_cross_load(tmp_path):
    p = tmp_path / "global.json"
    jpers.GlobalConfig(show_sources=False, show_filters=True).save(p)
    g = tpers.GlobalConfig.load(p)
    assert (g.show_sources, g.show_filters) == (False, True)
    tpers.GlobalConfig(show_filters=False).save(p)
    assert p.read_text() == json.dumps({"ShowSource": True, "ShowFilter": False})


def test_registry_matches_jax():
    """The same ids, names, kinds, versions, config classes and obsolete
    flags as the JAX registry; every source's default config equals JAX's."""
    assert list(REGISTRY) == list(jreg.REGISTRY)
    for k, info in REGISTRY.items():
        j = jreg.REGISTRY[k]
        assert (info.name, info.kind, info.version, info.obsolete, info.config_cls.__name__) == (
            j.name, j.kind, j.version, j.obsolete, j.config_cls.__name__)
        src = create_source(k, device="cpu")
        jsrc = jreg.create_source(k)
        assert config_to_dict(src.config) == jpers.config_to_dict(jsrc.config), k
    for kind in (None, "source", "filter"):
        for obs in (False, True):
            assert enum_sources(kind, obs) == jreg.enum_sources(kind, obs)
