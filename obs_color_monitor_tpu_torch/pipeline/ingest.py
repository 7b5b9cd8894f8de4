"""Frame sources: synthetic patterns, raw RGBA files, NV12 streams
(counterpart of ``obs_color_monitor_tpu/pipeline/ingest.py``, a copy on the
port's ``runtime.native``).

The reference captures frames from the OBS render graph (reference
src/common.c:141-168); a standalone framework needs its own ingest.  Frame
sources produce (H, W, 4) uint8 RGBA host frames; decoding/unpacking runs
in the native C++ runtime when available.
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, Optional

import numpy as np

from ..runtime import native


def _warn_trailing(path: str, got: int, want: int, count: int) -> None:
    """A PARTIAL trailing frame means a truncated/corrupt stream, not a
    clean end — say so (the reference logs every capture failure path,
    src/util.c:9-11, common.c:507-526; silence here hides real damage)."""
    if 0 < got < want:
        warnings.warn(
            f"{path}: truncated stream — trailing partial frame after "
            f"{count} whole frames ({got} of {want} bytes)",
            RuntimeWarning,
            stacklevel=3,
        )


class FrameSource:
    """Iterable of (H, W, 4) uint8 frames.

    Sources whose backing data is NV12-layout additionally set
    ``can_stream_nv12`` and yield raw (y, uv) WIRE plane pairs from
    :meth:`frames_nv12` — consumers can then decode ON DEVICE
    (``ops.convert.nv12_to_packed`` / ``Dock.push_nv12``): 1.5 B/px uploads
    and no host-side color conversion.  High-bit-depth
    NV12 layouts (P010-family) yield raw u16 planes and set
    ``nv12_shift`` > 0 — pass it to the push/decode call so the
    monitoring-domain round-shift ALSO runs on device (zero host
    per-pixel work; the planar/host routes keep shifting on host).
    """

    width: int
    height: int
    can_stream_nv12: bool = False
    nv12_shift: int = 0  # device round-shift for frames_nv12 planes

    def frames(self, n: Optional[int] = None) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def frames_nv12(self, n: Optional[int] = None):
        """Yield (y (H,W) u8, uv (H/2,W) u8) pairs; only when
        ``can_stream_nv12``."""
        raise NotImplementedError


class PatternSource(FrameSource):
    """Synthetic generator: 'bars' | 'ramp' | 'zoneplate' (native C++)."""

    def __init__(self, width: int, height: int, kind: str = "bars"):
        self.width, self.height, self.kind = width, height, kind

    def frames(self, n: Optional[int] = None) -> Iterator[np.ndarray]:
        i = 0
        while n is None or i < n:
            yield native.pattern(self.kind, self.width, self.height, i)
            i += 1


class RawRGBASource(FrameSource):
    """Raw .rgba file: concatenated H*W*4 frames."""

    def __init__(self, path: str, width: int, height: int):
        self.path, self.width, self.height = path, width, height
        self.frame_bytes = width * height * 4
        size = os.path.getsize(path)
        self.n_frames = size // self.frame_bytes
        _warn_trailing(path, size % self.frame_bytes, self.frame_bytes,
                       self.n_frames)

    def frames(self, n: Optional[int] = None) -> Iterator[np.ndarray]:
        count = self.n_frames if n is None else min(n, self.n_frames)
        with open(self.path, "rb") as f:
            for _ in range(count):
                buf = f.read(self.frame_bytes)
                if len(buf) < self.frame_bytes:
                    return
                yield np.frombuffer(buf, np.uint8).reshape(
                    self.height, self.width, 4
                )


class Y4MSource(FrameSource):
    """YUV4MPEG2 (.y4m) reader: C420* (all sitings), C422, C444, at 8-
    or high bit depth (C420p10/C422p12/...).

    The standard raw-video interchange format (ffmpeg: ``-f yuv4mpegpipe``).
    4:2:0 planes are interleaved to NV12 and converted through the native
    limited-range fixed-point kernel; 4:2:2 / 4:4:4 go through
    ``native.yuv_planes_to_rgba`` (nearest chroma upsample + the identical
    fixed-point math).  The C420 siting variants (jpeg/paldv/mpeg2) differ
    only in where the chroma samples sit, which a nearest upsample ignores
    — all are accepted and decoded alike.

    High-bit-depth tags (p10/p12/p14/p16, 16-bit LE planes) round-shift
    down to the 8-bit monitoring domain (``(v + half) >> (bits-8)``,
    clipped) before the identical conversion — the analog of OBS
    converting every source to its 8-bit BGRA canvas before the reference
    plugin ever reads pixels (reference src/common.c:170-221 operates on
    that canvas, never on source bit depth).
    """

    # chroma tag -> (x-subsample, y-subsample)
    _SUBSAMPLING = {"C420": (2, 2), "C422": (2, 1), "C444": (1, 1)}

    def __init__(self, path: str, cs: int = 2):
        self.path, self.cs = path, cs
        with open(path, "rb") as f:
            header = f.readline().decode("ascii", "replace")
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"{path}: not a YUV4MPEG2 stream")
        self.width = self.height = 0
        self.subsampling = self._SUBSAMPLING["C420"]  # y4m default
        self.bits = 8
        self.fps: Optional[float] = None  # recording tees pace/label by it
        for tok in header.split()[1:]:
            if tok.startswith("W"):
                self.width = int(tok[1:])
            elif tok.startswith("H"):
                self.height = int(tok[1:])
            elif tok.startswith("F"):
                # frame rate "F<num>:<den>" — carried so --out-video tees
                # label the recording at the source rate, not a 30fps guess
                try:
                    num, den = tok[1:].split(":")
                    if int(den) > 0 and int(num) > 0:
                        self.fps = int(num) / int(den)
                except ValueError:
                    pass  # malformed rate: leave unset, callers default
            elif tok.startswith("C"):
                # siting variants (C420jpeg/paldv/mpeg2) decode alike under
                # nearest upsampling; pN suffixes are 16-bit LE planes that
                # round-shift to 8 bits (reading them AS 8-bit would
                # silently misalign, hence the explicit tag parse)
                base = tok[:4]
                rest = tok[4:]
                if base not in self._SUBSAMPLING or (
                    rest not in ("", "jpeg", "paldv", "mpeg2", "p10",
                                 "p12", "p14", "p16")
                    or (rest in ("jpeg", "paldv", "mpeg2") and base != "C420")
                ):
                    raise ValueError(
                        f"{path}: unsupported chroma {tok} (supported: "
                        f"C420/C420jpeg/C420paldv/C420mpeg2, C422, C444, "
                        f"each also at p10/p12/p14/p16)"
                    )
                self.subsampling = self._SUBSAMPLING[base]
                if rest in ("p10", "p12", "p14", "p16"):
                    self.bits = int(rest[1:])
        if not self.width or not self.height:
            raise ValueError(f"{path}: missing W/H in header")
        self._header_len = len(header.encode())

    def _to8(self, plane: np.ndarray) -> np.ndarray:
        """Round-shift a high-bit-depth plane to u8 (round half up, clip:
        e.g. p10 1023 -> (1023+2)>>2 = 256 -> 255)."""
        shift = self.bits - 8
        v = (plane.astype(np.uint32) + (1 << (shift - 1))) >> shift
        return np.minimum(v, 255).astype(np.uint8)

    @property
    def can_stream_nv12(self) -> bool:  # type: ignore[override]
        # even dims: the NV12 interleave (and the device decode kernel's
        # 2x2 chroma upsample) needs whole sample pairs on both axes
        return (
            self.subsampling == (2, 2)
            and self.width % 2 == 0
            and self.height % 2 == 0
        )

    def _raw_planes(self, n: Optional[int]):
        """Yield decoded-to-8-bit (y, u, v) planes per frame."""
        w, h = self.width, self.height
        sx, sy = self.subsampling
        cw, ch = -(-w // sx), -(-h // sy)
        ysz, csz = w * h, cw * ch
        dtype = np.dtype(np.uint8) if self.bits == 8 else np.dtype("<u2")
        nbytes = dtype.itemsize
        count = 0
        with open(self.path, "rb") as f:
            f.seek(self._header_len)
            while n is None or count < n:
                marker = f.readline()
                if not marker.startswith(b"FRAME"):
                    if marker.strip():
                        warnings.warn(
                            f"{self.path}: corrupt frame marker "
                            f"{marker[:32]!r} after {count} frames",
                            RuntimeWarning,
                            stacklevel=2,
                        )
                    return
                buf = f.read((ysz + 2 * csz) * nbytes)
                if len(buf) < (ysz + 2 * csz) * nbytes:
                    _warn_trailing(
                        self.path, len(buf), (ysz + 2 * csz) * nbytes, count
                    )
                    return
                planes = np.frombuffer(buf, dtype)
                y = planes[:ysz].reshape(h, w)
                u = planes[ysz : ysz + csz].reshape(ch, cw)
                v = planes[ysz + csz :].reshape(ch, cw)
                if self.bits != 8:
                    y, u, v = self._to8(y), self._to8(u), self._to8(v)
                yield y, u, v
                count += 1

    def frames(self, n: Optional[int] = None) -> Iterator[np.ndarray]:
        sxy = self.subsampling
        w = self.width
        for y, u, v in self._raw_planes(n):
            if sxy == (2, 2) and w % 2 == 0:
                uv = np.empty((u.shape[0], w), np.uint8)
                uv[:, 0::2] = u
                uv[:, 1::2] = v
                yield native.nv12_to_rgba(y, uv, cs=self.cs)
            else:
                # odd width / 422 / 444: the NV12 interleave needs an even
                # column count; the planar path applies the identical
                # fixed-point math with a nearest upsample
                yield native.yuv_planes_to_rgba(y, u, v, cs=self.cs)

    def frames_nv12(self, n: Optional[int] = None):
        """(y, uv) pairs for device-side decode (can_stream_nv12 only)."""
        if not self.can_stream_nv12:
            raise ValueError(
                f"{self.path}: not NV12-streamable (needs C420 with even "
                f"dimensions, got C{self.subsampling} {self.width}x"
                f"{self.height})"
            )
        w = self.width
        for y, u, v in self._raw_planes(n):
            uv = np.empty((u.shape[0], w), np.uint8)
            uv[:, 0::2] = u
            uv[:, 1::2] = v
            yield y, uv


class FFmpegSource(FrameSource):
    """Any container/codec ffmpeg can decode (mp4, mkv, webm, live URLs...),
    streamed as raw RGBA through an ``ffmpeg`` subprocess pipe.

    The reference monitors arbitrary OBS sources — media files included
    (reference README.md:5-15, the OBS media source does its own ffmpeg
    decode); the standalone analog shells out to the system ffmpeg (GATED
    on the binary being present — nothing is vendored or linked).

    The frame size is parsed from ffmpeg's own stream banner unless given
    explicitly; ``fps`` (probed the same way) lets live sinks pace
    playback.
    """

    def __init__(
        self,
        path: str,
        width: Optional[int] = None,
        height: Optional[int] = None,
        ffmpeg: str = "ffmpeg",
    ):
        import shutil

        self.path, self._ffmpeg = path, ffmpeg
        if shutil.which(ffmpeg) is None:
            raise RuntimeError(
                f"{ffmpeg!r} not found on PATH — FFmpegSource needs a "
                f"system ffmpeg (or pass raw .rgba/.nv12/.y4m files instead)"
            )
        self.fps: Optional[float] = None
        if width is None or height is None:
            width, height, self.fps = self._probe()
        self.width, self.height = width, height
        self.frame_bytes = width * height * 4

    def _probe(self) -> tuple[int, int, Optional[float]]:
        """Parse WxH (and fps) from the ``ffmpeg -i`` stream banner — works
        without ffprobe, which minimal installs omit."""
        import re
        import subprocess

        proc = subprocess.run(
            [self._ffmpeg, "-hide_banner", "-i", self.path],
            capture_output=True,
            text=True,
        )  # exits non-zero by design (no output file) — only stderr matters
        banner = proc.stderr
        m = re.search(r"Video:.*?\s(\d{2,5})x(\d{2,5})[\s,]", banner)
        if m is None:
            raise ValueError(
                f"{self.path}: could not parse frame size from ffmpeg "
                f"banner; pass width/height explicitly"
            )
        fm = re.search(r"(\d+(?:\.\d+)?)\s*fps", banner)
        return (
            int(m.group(1)),
            int(m.group(2)),
            float(fm.group(1)) if fm else None,
        )

    def frames(self, n: Optional[int] = None) -> Iterator[np.ndarray]:
        """Decoded RGBA frames.  A mid-stream decoder failure is NOT a
        silent end-of-stream: when ffmpeg exits nonzero before the pipe
        runs dry on its own terms, a RuntimeError carries the tail of its
        stderr (the reference logs every capture failure path,
        src/util.c:9-11, common.c:507-526).  Stopping the iterator early
        (or after the requested ``n``) terminates ffmpeg quietly."""
        import subprocess
        import threading
        from collections import deque

        cmd = [
            self._ffmpeg, "-v", "error", "-i", self.path,
            "-f", "rawvideo", "-pix_fmt", "rgba", "pipe:1",
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE
        )
        tail: deque = deque(maxlen=40)

        def _drain():  # keep ffmpeg from blocking on a full stderr pipe
            for line in proc.stderr:
                tail.append(line)
            proc.stderr.close()

        drainer = threading.Thread(target=_drain, daemon=True)
        drainer.start()
        count = 0
        eof = False
        last = b""
        try:
            while n is None or count < n:
                buf = proc.stdout.read(self.frame_bytes)
                if buf is None or len(buf) < self.frame_bytes:
                    eof = True
                    last = buf or b""
                    break
                yield np.frombuffer(buf, np.uint8).reshape(
                    self.height, self.width, 4
                )
                count += 1
        finally:
            proc.stdout.close()
            if not eof:
                # consumer stopped early / got its n frames: a SIGTERM'd
                # ffmpeg exits nonzero by design — not a failure
                proc.terminate()
            rc = proc.wait()
            drainer.join(timeout=3)
            if eof:
                if rc != 0:
                    msg = (
                        b"".join(tail).decode(errors="replace").strip()
                    )[-2000:]
                    raise RuntimeError(
                        f"{self.path}: ffmpeg exited with status {rc} "
                        f"after {count} frames"
                        + (f"\n{msg}" if msg else "")
                    )
                _warn_trailing(self.path, len(last), self.frame_bytes, count)


class NV12Source(FrameSource):
    """Raw NV12 stream (Y plane + interleaved CbCr at half vertical res),
    or its high-bit-depth layout (``bits=10`` = P010-style 16-bit LE
    samples, also 12/14/16).

    Converted to RGBA through the native runtime's limited-range
    BT.601/709 fixed-point kernel (csrc/ocm_runtime.cpp); >8-bit samples
    round-shift to the 8-bit monitoring domain (same policy as
    `Y4MSource`) — on the host for the RGBA/planar route, ON DEVICE for
    the NV12 streaming route (``frames_nv12`` yields the raw u16 wire
    planes and ``nv12_shift`` carries the shift; the push/decode fuses
    it, zero host per-pixel work).  NOTE: real P010 stores the 10
    significant bits in the TOP of each 16-bit word; pass
    ``msb_aligned=True`` for that layout (the shift then drops the
    zero-padded low bits instead).
    """

    def __init__(self, path: str, width: int, height: int, cs: int = 2,
                 bits: int = 8, msb_aligned: bool = False):
        if bits not in (8, 10, 12, 14, 16):
            raise ValueError(f"bits must be 8/10/12/14/16, got {bits}")
        self.path, self.width, self.height, self.cs = path, width, height, cs
        self.bits, self.msb_aligned = bits, msb_aligned
        from ..ops.convert import nv12_shift

        self.nv12_shift = nv12_shift(bits, msb_aligned)
        self._nbytes = 1 if bits == 8 else 2
        self.frame_bytes = width * height * 3 // 2 * self._nbytes
        size = os.path.getsize(path)
        self.n_frames = size // self.frame_bytes
        # raw streams have no framing: a partial trailing frame means the
        # geometry/bits are wrong or the file is truncated — say so
        _warn_trailing(path, size % self.frame_bytes, self.frame_bytes,
                       self.n_frames)

    def _to8(self, plane: np.ndarray) -> np.ndarray:
        shift = (8 if self.msb_aligned else self.bits - 8)
        v = (plane.astype(np.uint32) + (1 << (shift - 1))) >> shift
        return np.minimum(v, 255).astype(np.uint8)

    @property
    def can_stream_nv12(self) -> bool:  # type: ignore[override]
        return self.width % 2 == 0 and self.height % 2 == 0

    def frames_nv12(self, n: Optional[int] = None):
        """(y, uv) WIRE plane pairs for device-side decode: u8 for
        bits=8, raw u16 for the >8-bit layouts — pass ``self.nv12_shift``
        to the push/decode call and the monitoring-domain round-shift
        fuses into the on-device decode (zero host per-pixel work; the y
        and uv planes are adjacent views of one file-read buffer, so
        ``ops.nv12_device_planes`` uploads them in ONE transfer)."""
        count = self.n_frames if n is None else min(n, self.n_frames)
        ysz = self.width * self.height
        dtype = np.dtype(np.uint8) if self.bits == 8 else np.dtype("<u2")
        with open(self.path, "rb") as f:
            for i in range(count):
                buf = f.read(self.frame_bytes)
                if len(buf) < self.frame_bytes:
                    _warn_trailing(self.path, len(buf), self.frame_bytes, i)
                    return
                samples = np.frombuffer(buf, dtype)
                y = samples[:ysz].reshape(self.height, self.width)
                uv = samples[ysz:].reshape(self.height // 2, self.width)
                yield y, uv

    def frames(self, n: Optional[int] = None) -> Iterator[np.ndarray]:
        # host route: shift on host (the native decoder is 8-bit)
        for y, uv in self.frames_nv12(n):
            if self.bits != 8:
                y, uv = self._to8(y), self._to8(uv)
            yield native.nv12_to_rgba(y, uv, cs=self.cs)
