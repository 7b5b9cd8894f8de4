"""The port's CLI (``python -m obs_color_monitor_tpu_torch``) on the CPU.

The CLI cases of ``tests/test_sinks.py`` and ``tests/test_persistence_cli.py``
run on the port with ``--device cpu``; then the port's CLI and the JAX
package's on the same pattern and the same ``.nv12`` file write PNGs whose
decoded pixels are equal (exact): the dock (fan-out and ``--out-video``
routes), ``--one-program``, ``--roi`` and ``scope vectorscope``.  The dock
comparisons load one settings file, written by the JAX package, with the
histogram in PIXEL levels: JAX's CPU render leaves a pixel empty at an
exact AUTO-level tie where the port fills it
(``tests/test_torch_dynamic_roi.py::test_histogram_tie_follows_golden``).
``--device cuda`` on a host without a CUDA GPU exits non-zero and runs
nothing.
"""

import io
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu import __main__ as jcli
from obs_color_monitor_tpu import config as J
from obs_color_monitor_tpu import models as jm
from obs_color_monitor_tpu.utils import persistence as jpers
from obs_color_monitor_tpu_torch import __main__ as tcli
from obs_color_monitor_tpu_torch.pipeline.ingest import Y4MSource

torch.set_num_threads(1)


def main(argv):
    """The port's CLI on the CPU."""
    return tcli.main(list(argv) + ["--device", "cpu"])


def _png(path) -> np.ndarray:
    """Decode a PNG: through PIL where present, else the filter-0 rows the
    package's own encoder writes."""
    data = open(path, "rb").read()
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        img = Image.open(io.BytesIO(data))
        return np.asarray(img.convert("RGBA" if img.mode in ("RGBA", "P") else "RGB"))
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, _, ctype = ihdr[:4]
    c = 4 if ctype == 6 else 3
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all(), "only filter-0 rows are decoded here"
    return rows[:, 1:].reshape(h, w, c)


def test_cli_dock_out_video(tmp_path):
    out = tmp_path / "dock.png"
    vid = tmp_path / "dock.y4m"
    rc = main([
        "dock", "--pattern", "bars", "--size", "192x108",
        "--frames", "4", "--interleave", "0",
        "--out", str(out), "--out-video", str(vid),
        "--out-width", "128", "--out-height", "384",
    ])
    assert rc == 0
    src = Y4MSource(str(vid), cs=2)
    assert (src.width, src.height) == (128, 384)
    frames = list(src.frames())
    assert len(frames) == 4
    # the recorded panel is the rendered dock, not blank
    assert np.asarray(frames[-1])[..., :3].std() > 1
    assert out.exists()


def test_cli_dock_out_video_one_program(tmp_path):
    """--out-video also records on the one-program (make_dock_step)
    route, where a panel is rendered per frame anyway."""
    vid = tmp_path / "dock1p.y4m"
    rc = main([
        "dock", "--pattern", "ramp", "--size", "192x108",
        "--frames", "3", "--one-program",
        "--out", str(tmp_path / "d.png"), "--out-video", str(vid),
        "--out-width", "128", "--out-height", "384",
    ])
    assert rc == 0
    assert len(list(Y4MSource(str(vid), cs=2).frames())) == 3


def test_cli_live_out_video_tee(tmp_path, capsys):
    """--out-video on the --live route records what the MJPEG server
    publishes (the recording tee, both for dock and per-scope views)."""
    vid = tmp_path / "live.y4m"
    rc = main([
        "scope", "zebra", "--pattern", "bars", "--size", "64x48",
        "--frames", "3", "--live", "--port", "0", "--fps", "240",
        "--out", str(tmp_path / "z.png"), "--out-video", str(vid),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "published 3" in out
    assert "video: 3 frames" in out
    assert len(list(Y4MSource(str(vid), cs=2).frames())) == 3


def test_cli_scope_out_video(tmp_path):
    vid = tmp_path / "vs.y4m"
    rc = main([
        "scope", "vectorscope", "--pattern", "ramp", "--size", "160x90",
        "--frames", "3", "--out", str(tmp_path / "vs.png"),
        "--out-video", str(vid),
    ])
    assert rc == 0
    src = Y4MSource(str(vid), cs=2)
    assert (src.width, src.height) == (256, 256)
    assert len(list(src.frames())) == 3


def test_cli_scope(tmp_path):
    out = tmp_path / "hist.png"
    rc = main(
        [
            "scope",
            "histogram",
            "--pattern",
            "ramp",
            "--size",
            "128x64",
            "--frames",
            "2",
            "--scale",
            "1",
            "--out",
            str(out),
        ]
    )
    assert rc == 0 and out.exists()


def test_cli_dock_settings_roundtrip(tmp_path):
    out = tmp_path / "dock.png"
    settings = tmp_path / "s.json"
    rc = main(
        [
            "dock",
            "--pattern",
            "bars",
            "--size",
            "128x64",
            "--frames",
            "2",
            "--scale",
            "1",
            "--interleave",
            "0",
            "--out-width",
            "128",
            "--out-height",
            "512",
            "--out",
            str(out),
            "--save-settings",
            str(settings),
        ]
    )
    assert rc == 0 and out.exists() and settings.exists()
    data = json.loads(settings.read_text())
    assert data["roi-prop"]["target_scale"] == 1


def test_cli_dock_roi(tmp_path):
    out = tmp_path / "roi.png"
    rc = main(
        [
            "dock", "--pattern", "bars", "--size", "128x64", "--frames", "2",
            "--scale", "1", "--interleave", "0", "--roi", "16,8,80,56",
            "--out-width", "128", "--out-height", "600", "--out", str(out),
        ]
    )
    assert rc == 0 and out.exists()


# ---------------------------------------------------------------------------
# the port's CLI against the JAX package's (exact)
# ---------------------------------------------------------------------------

W, H = 96, 64


def _settings(tmp_path, **roi) -> str:
    """A dock settings file written by the JAX package: PIXEL histogram
    levels, focus peaking shown, the given ROI fields."""
    d = jm.Dock(J.DockConfig(show_focuspeaking=True),
                roi=J.ROIConfig(**roi),
                histogram=J.HistogramConfig(level_mode=J.LevelMode.PIXEL))
    path = tmp_path / "settings.json"
    jpers.save_dock(d, path)
    return str(path)


def _nv12_file(tmp_path, frames=3) -> str:
    rng = np.random.default_rng(7)
    p = tmp_path / "clip.nv12"
    p.write_bytes(rng.integers(0, 256, (frames, H * 3 // 2, W), np.uint8).tobytes())
    return str(p)


def _both(tmp_path, args):
    """Run the JAX CLI and the port's on ``args``; the two PNGs decoded."""
    out = []
    for name, run in (("jax", jcli.main), ("port", main)):
        png = tmp_path / f"{name}.png"
        assert run(list(args) + ["--out", str(png)]) == 0, name
        out.append(_png(png))
    return out


DOCK_CASES = {
    "pattern": (dict(target_scale=2, interleave=0),
                ["--pattern", "bars", "--size", f"{W}x{H}", "--frames", "3", "--scale", "2",
                 "--interleave", "0"]),
    "nv12": (dict(target_scale=1, interleave=0),
             ["--size", f"{W}x{H}", "--frames", "3", "--scale", "1", "--interleave", "0"]),
    "one_program": (dict(target_scale=2, interleave=0),
                    ["--pattern", "ramp", "--size", f"{W}x{H}", "--frames", "2", "--scale", "2",
                     "--interleave", "0", "--one-program"]),
    "roi": (dict(target_scale=1, interleave=0, x0=8, y0=4, x1=72, y1=52),
            ["--pattern", "zoneplate", "--size", f"{W}x{H}", "--frames", "2", "--scale", "1",
             "--interleave", "0", "--roi", "8,4,72,52"]),
    "nv12_one_program": (dict(target_scale=1, interleave=0),
                         ["--size", f"{W}x{H}", "--frames", "2", "--scale", "1",
                          "--interleave", "0", "--one-program"]),
    "out_video": (dict(target_scale=2, interleave=1),
                  ["--pattern", "bars", "--size", f"{W}x{H}", "--frames", "4", "--scale", "2",
                   "--interleave", "1", "--out-video", "VIDEO"]),
}


@pytest.mark.parametrize("case", sorted(DOCK_CASES))
def test_cli_dock_png_matches_jax(tmp_path, case):
    roi, args = DOCK_CASES[case]
    args = ["dock", *args, "--out-width", "128", "--out-height", "520",
            "--load-settings", _settings(tmp_path, **roi)]
    if case.startswith("nv12"):
        args += ["--input", _nv12_file(tmp_path)]
    if "VIDEO" in args:
        args[args.index("VIDEO")] = str(tmp_path / "panel.y4m")
    jax_png, port_png = _both(tmp_path, args)
    assert port_png.shape == (520, 128, 4)
    np.testing.assert_array_equal(port_png, jax_png)


@pytest.mark.parametrize("scope,source", [("vectorscope", "pattern"), ("vectorscope", "nv12"),
                                          ("waveform", "nv12"), ("histogram", "pattern")])
def test_cli_scope_png_matches_jax(tmp_path, scope, source):
    args = ["scope", scope, "--size", f"{W}x{H}", "--frames", "2", "--scale", "1"]
    args += (["--input", _nv12_file(tmp_path)] if source == "nv12"
             else ["--pattern", "ramp"])
    if scope == "histogram":  # AUTO levels, the ramp's bins away from ties
        args[args.index("ramp")] = "zoneplate"
    jax_png, port_png = _both(tmp_path, args)
    np.testing.assert_array_equal(port_png, jax_png)


def test_cli_settings_saved_by_port_load_in_jax(tmp_path):
    """--save-settings of the port's CLI writes what the JAX CLI's
    --load-settings reads into the same dock configs."""
    s = tmp_path / "port.json"
    assert main(["dock", "--pattern", "bars", "--size", "64x48", "--frames", "1",
                 "--scale", "1", "--interleave", "0", "--roi", "4,4,40,30",
                 "--out", str(tmp_path / "a.png"), "--save-settings", str(s)]) == 0
    d = jm.Dock()
    jpers.load_dock(d, s)
    assert jpers.dock_save_data(d) == json.loads(s.read_text())
    assert (d.hub.config.x0, d.hub.config.x1, d.hub.config.target_scale) == (4, 40, 1)


# ---------------------------------------------------------------------------
# --device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["dock", "--pattern", "bars", "--size", "64x48", "--frames", "2"],
    ["scope", "vectorscope", "--pattern", "bars", "--size", "64x48", "--frames", "2"],
    ["dock", "--pattern", "bars", "--size", "64x48", "--frames", "2", "--live", "--port", "0"],
    ["info"],
])
def test_cli_cuda_without_a_card_exits_nonzero(tmp_path, monkeypatch, capsys, argv):
    """The default ``--device cuda`` on a host without a CUDA GPU exits
    non-zero with a message, and nothing runs on the CPU instead: no scope
    is made and no file written."""
    from obs_color_monitor_tpu_torch import models

    def refuse(*a, **k):
        raise AssertionError("a scope was made on the CPU")

    for name in ("Dock", "Vectorscope", "Histogram", "Waveform"):
        monkeypatch.setattr(models, name, refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.png"
    args = list(argv) + (["--out", str(out)] if argv[0] != "info" else [])
    assert tcli.main(args) == 2
    assert tcli.main(args + ["--device", "cuda"]) == 2
    err = capsys.readouterr().err
    assert "no CUDA GPU" in err and "--device cpu" in err
    assert not out.exists()


def test_cli_info_cpu(capsys):
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["torch"] == torch.__version__ and info["device"] == "cpu"
    assert info["device_name"] is None and info["kernels_built"] in (True, False)
    assert info["native_runtime"] in (True, False)
    assert "jax" not in info
