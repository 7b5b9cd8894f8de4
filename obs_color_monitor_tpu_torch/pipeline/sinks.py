"""Video output sinks: record rendered scope panels to a video stream
(counterpart of ``obs_color_monitor_tpu/pipeline/sinks.py``, a copy).

The reference's output surface is the live Qt dock inside OBS — and OBS
itself records/streams whatever it displays.  The standalone analogs here
are (a) the MJPEG live server (`pipeline.live`) and (b) these file sinks,
which close the ingest loop: `pipeline.ingest` reads y4m/raw/ffmpeg
streams in, these write the composited panel (or any RGBA frame sequence)
back out.

`Y4MSink` is self-contained (no external binaries): YUV4MPEG2 C444 with
the standard limited-range BT.601/709 forward matrices in the same 12-bit
fixed point as the native decoder (csrc/ocm_runtime.cpp
`ocm_nv12_to_rgba`), so a write→read round trip through `Y4MSource`
reproduces the input to within quantization.  C444 keeps the sink
spatially lossless.  `FFmpegSink` encodes to any container the system
ffmpeg supports (gated on the binary, mirroring `ingest.FFmpegSource`).

Recording is 8-bit BY DESIGN (even though ingest reads p10..p16 sources):
what these sinks record are rendered scope PANELS, which are 8-bit RGBA
end to end — the monitoring domain itself is 8-bit (the reference reads
pixels from OBS's 8-bit BGRA canvas, src/common.c:170-221, and records
nothing at all).  High-bit-depth SOURCES round-shift to that domain at
ingest; there is no >8-bit data anywhere downstream to preserve.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np

# Forward limited-range RGB -> Y'CbCr, round(c * 4096) of the standard
# matrices (Y rows scaled by 219/255, chroma rows by 224/255).  Each
# chroma row sums to exactly 0, so gray maps to Cb=Cr=128 exactly; the Y
# row sums to 3518 = round(219/255 * 4096), the inverse of the decoder's
# ky=4769 (csrc/ocm_runtime.cpp:147).
_FWD = {
    # cs=1: BT.601 (Kr=0.299, Kb=0.114)
    1: (
        (1052, 2065, 401),  # Y  (+16)
        (-607, -1192, 1799),  # Cb (+128)
        (1799, -1506, -293),  # Cr (+128)
    ),
    # cs=2: BT.709 (Kr=0.2126, Kb=0.0722)
    2: (
        (748, 2516, 254),
        (-412, -1387, 1799),
        (1799, -1634, -165),
    ),
}


def rgb_to_yuv_limited(rgba: np.ndarray, cs: int = 2):
    """(H, W, 3|4) uint8 -> (Y, U, V) uint8 planes, limited range.

    12-bit fixed point with round-half-up (`+2048 >> 12`), matching the
    native decoder's arithmetic style; output is clipped to the studio
    ranges [16, 235] / [16, 240] so any encoder downstream sees legal
    levels.
    """
    if cs not in _FWD:
        raise ValueError(f"cs must be 1 (BT.601) or 2 (BT.709), got {cs}")
    ky, kcb, kcr = _FWD[cs]
    rgb = rgba[..., :3].astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]

    def mix(k, bias, lo, hi):
        v = ((k[0] * r + k[1] * g + k[2] * b + 2048) >> 12) + bias
        return np.clip(v, lo, hi).astype(np.uint8)

    return (
        mix(ky, 16, 16, 235),
        mix(kcb, 128, 16, 240),
        mix(kcr, 128, 16, 240),
    )


class VideoSink:
    """Writable sequence of (H, W, 3|4) uint8 RGBA frames."""

    width: int
    height: int
    n_written: int = 0

    def write(self, frame: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _check(self, frame: np.ndarray) -> np.ndarray:
        frame = np.asarray(frame)
        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] not in (3, 4):
            raise ValueError(
                f"expected (H, W, 3|4) uint8 frame, got {frame.dtype} {frame.shape}"
            )
        if frame.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"frame is {frame.shape[1]}x{frame.shape[0]}, sink is "
                f"{self.width}x{self.height}"
            )
        return frame


class Y4MSink(VideoSink):
    """YUV4MPEG2 writer, C444 limited-range (no external dependencies).

    The written stream reads back through `ingest.Y4MSource` (which
    accepts C444) and plays in ffmpeg/mpv/VLC directly.
    """

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 30.0, cs: int = 2):
        if width <= 0 or height <= 0:
            raise ValueError(f"bad geometry {width}x{height}")
        if cs not in _FWD:
            raise ValueError(f"cs must be 1 (BT.601) or 2 (BT.709), got {cs}")
        self.path, self.width, self.height, self.cs = path, width, height, cs
        frac = Fraction(fps).limit_denominator(65536)
        if frac <= 0:
            raise ValueError(f"bad fps {fps}")
        self._f = open(path, "wb")
        self._f.write(
            f"YUV4MPEG2 W{width} H{height} F{frac.numerator}:"
            f"{frac.denominator} Ip A1:1 C444\n".encode("ascii")
        )
        self.n_written = 0

    def write(self, frame: np.ndarray) -> None:
        frame = self._check(frame)
        y, u, v = rgb_to_yuv_limited(frame, cs=self.cs)
        self._f.write(b"FRAME\n")
        self._f.write(y.tobytes())
        self._f.write(u.tobytes())
        self._f.write(v.tobytes())
        self.n_written += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


# ffmpeg names for the two colorspaces (metadata tags + the swscale
# RGB->YUV matrix the encoder conversion should use)
_FFMPEG_CS = {1: "smpte170m", 2: "bt709"}


def ffmpeg_sink_cmd(path: str, width: int, height: int, fps: float,
                    ffmpeg: str = "ffmpeg", cs: int = 2,
                    extra_args: Optional[list] = None) -> list:
    """The FFmpegSink command line (factored out so tests can check the
    encode options without an ffmpeg binary present).

    Output options pin what ffmpeg would otherwise guess from the rgba
    input: ``-pix_fmt yuv420p`` (libx264 defaults to yuv444p for rgba —
    a High 4:4:4 profile most players and hardware decoders refuse; odd
    dimensions are padded to even in the filter chain so 4:2:0 is always
    possible) and the colorimetry both as stream metadata and as the
    actual swscale conversion matrix/range.  ``extra_args`` come AFTER
    the defaults, so callers can override any of them (ffmpeg lets the
    last flag win).
    """
    cs_name = _FFMPEG_CS.get(int(cs), "bt709")
    vf = f"scale=out_color_matrix={cs_name}:out_range=tv"
    if width % 2 or height % 2:
        # odd dims can't be 4:2:0; pad to even (one black row/column) so
        # yuv420p can always be pinned — odd-sized scope panels are common
        # (waveform width follows the target) and a High 4:4:4 fallback is
        # refused by most players/hardware decoders
        vf += ",pad=ceil(iw/2)*2:ceil(ih/2)*2"
    out_opts = [
        "-vf", vf,
        "-colorspace", cs_name,
        "-color_primaries", cs_name,
        "-color_trc", cs_name,
        "-pix_fmt", "yuv420p",
    ]
    return [
        ffmpeg, "-v", "error", "-y",
        "-f", "rawvideo", "-pix_fmt", "rgba",
        "-s", f"{width}x{height}", "-r", f"{fps:g}",
        "-i", "pipe:0",
    ] + out_opts + (extra_args or []) + [path]


class FFmpegSink(VideoSink):
    """Encode to any container/codec via the system ffmpeg (mp4, mkv,
    webm, ...), raw RGBA piped over stdin.

    GATED on the binary being present — nothing is vendored or linked
    (same policy as `ingest.FFmpegSource`).  Extra encoder args (codec,
    crf, ...) pass through `extra_args`; see `ffmpeg_sink_cmd` for the
    pinned defaults (yuv420p, colorimetry matching ``cs``).
    """

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 30.0, ffmpeg: str = "ffmpeg",
                 cs: int = 2, extra_args: Optional[list] = None):
        import shutil
        import subprocess

        if shutil.which(ffmpeg) is None:
            raise RuntimeError(
                f"{ffmpeg!r} not found on PATH — FFmpegSink needs a system "
                f"ffmpeg (write .y4m via Y4MSink instead)"
            )
        if width <= 0 or height <= 0:
            raise ValueError(f"bad geometry {width}x{height}")
        self.path, self.width, self.height = path, width, height
        cmd = ffmpeg_sink_cmd(path, width, height, fps, ffmpeg=ffmpeg,
                              cs=cs, extra_args=extra_args)
        # own session: an interactive Ctrl-C delivers SIGINT to the whole
        # foreground process group — without isolation ffmpeg dies with a
        # nonzero status on every interactive stop and close() raises on
        # an otherwise-clean recording.  ffmpeg still finalizes normally
        # when close() shuts its stdin.
        self._proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, start_new_session=True
        )
        self.n_written = 0

    def write(self, frame: np.ndarray) -> None:
        frame = self._check(frame)
        if frame.shape[2] == 3:  # encoder pipe expects rgba
            frame = np.dstack(
                [frame, np.full(frame.shape[:2], 255, np.uint8)]
            )
        self._proc.stdin.write(frame.tobytes())
        self.n_written += 1

    def close(self) -> None:
        if self._proc.stdin and not self._proc.stdin.closed:
            self._proc.stdin.close()
        rc = self._proc.wait()
        if rc != 0:
            raise RuntimeError(f"ffmpeg exited with status {rc}")


def open_video_sink(path: str, width: int, height: int,
                    fps: float = 30.0, cs: int = 2) -> VideoSink:
    """Dispatch on extension: ``.y4m`` is written natively, anything else
    encodes through the system ffmpeg (with matching colorimetry)."""
    if path.endswith(".y4m"):
        return Y4MSink(path, width, height, fps=fps, cs=cs)
    return FFmpegSink(path, width, height, fps=fps, cs=cs)


class RecordingTee:
    """Record every rendered frame alongside the primary CLI output.

    Shared by all three recording routes (``dock``, ``dock --live`` /
    ``scope --live``, ``scope``): resolves the frame rate once
    (explicit ``--fps`` > the source's own probed/parsed rate > 30),
    opens the sink lazily on the first frame (scope images size
    themselves — e.g. the waveform width follows the target), and
    reports the frame count on close.

    ``close(raise_errors=False)`` downgrades sink-close failures (e.g.
    FFmpegSink's nonzero-exit RuntimeError) to a stderr message — for
    ``finally`` blocks where raising would mask the in-flight exception.
    """

    def __init__(self, path: str, fps_arg: float, src, cs: int = 2):
        self.path, self.cs = path, cs
        self.fps = fps_arg or getattr(src, "fps", None) or 30.0
        self._sink: Optional[VideoSink] = None

    @property
    def n_written(self) -> int:
        return self._sink.n_written if self._sink is not None else 0

    def write(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if self._sink is None:
            self._sink = open_video_sink(
                self.path, img.shape[1], img.shape[0],
                fps=self.fps, cs=self.cs,
            )
        self._sink.write(img)
        return img

    def close(self, raise_errors: bool = True) -> None:
        if self._sink is None:
            return
        sink, self._sink = self._sink, None
        try:
            sink.close()
        except Exception as e:
            if raise_errors:
                raise
            import sys

            print(f"video sink close failed: {e}", file=sys.stderr)
            return
        print(f"video: {sink.n_written} frames -> {self.path}")
