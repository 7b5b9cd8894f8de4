"""ctypes bindings for the native host runtime (csrc/ocm_runtime.cpp).

Counterpart of ``obs_color_monitor_tpu/runtime/native.py``: the same
entry points, signatures and NumPy fallbacks.  It builds the same
``csrc/ocm_runtime.cpp`` (repository root) with g++ on first use, into the
port's own ``_build/`` directory, under a name keyed on a hash of the
source and the compiler flags, linked under a temporary name and renamed
so that concurrent builds never load a torn file.  Every entry point has a
NumPy fallback so the framework works without a compiler; ``available()``
reports which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "csrc" / "ocm_runtime.cpp"
_LIB_DIR = Path(__file__).resolve().parents[1] / "_build"
# portable code (no -march=native): the build directory may travel to a
# host with another CPU.  The source uses std::string without including
# <string>, which GCC 13's headers no longer pull in through the others it
# includes, so the header is force-included.
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-include", "string")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _LIB_DIR / f"libocm_runtime_{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        _LIB_DIR.mkdir(parents=True, exist_ok=True)
        cmd = ["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp), "-lpthread"]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        lib_path = _lib_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        # signatures
        lib.ocm_queue_create.restype = ctypes.c_void_p
        lib.ocm_queue_create.argtypes = [ctypes.c_int, ctypes.c_size_t]
        lib.ocm_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.ocm_queue_push.restype = ctypes.c_int
        lib.ocm_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ocm_queue_pop.restype = ctypes.c_int
        lib.ocm_queue_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double]
        lib.ocm_queue_close.argtypes = [ctypes.c_void_p]
        lib.ocm_queue_size.restype = ctypes.c_int
        lib.ocm_queue_size.argtypes = [ctypes.c_void_p]
        lib.ocm_queue_pushed.restype = ctypes.c_uint64
        lib.ocm_queue_pushed.argtypes = [ctypes.c_void_p]
        lib.ocm_queue_dropped.restype = ctypes.c_uint64
        lib.ocm_queue_dropped.argtypes = [ctypes.c_void_p]
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.ocm_nv12_to_rgba.argtypes = [
            u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int,
        ]
        lib.ocm_deinterleave_rgba.argtypes = [u8p, ctypes.c_int64, u8p, u8p, u8p, u8p]
        lib.ocm_interleave_rgba.argtypes = [u8p, u8p, u8p, u8p, ctypes.c_int64, u8p]
        for f in ("ocm_pattern_bars", "ocm_pattern_ramp", "ocm_pattern_zoneplate"):
            getattr(lib, f).argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ocm_reader_start.restype = ctypes.c_void_p
        lib.ocm_reader_start.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
        ]
        lib.ocm_reader_stop.argtypes = [ctypes.c_void_p]
        lib.ocm_reader_frames_read.restype = ctypes.c_uint64
        lib.ocm_reader_frames_read.argtypes = [ctypes.c_void_p]
        lib.ocm_reader_finished.restype = ctypes.c_int
        lib.ocm_reader_finished.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# NV12 -> RGBA (native or NumPy fallback; identical fixed-point spec)
# ---------------------------------------------------------------------------

_NV12_COEF = {
    1: (6537, -1605, -3330, 8263),
    2: (7343, -873, -2183, 8652),
}
_KY = 4769


def nv12_to_rgba(
    y: np.ndarray, uv: np.ndarray, cs: int = 2
) -> np.ndarray:
    """NV12 (y (H,W) u8, uv (H/2, W) u8 interleaved CbCr) -> RGBA u8.

    Limited-range inverse conversion, 12-bit fixed point (see
    csrc/ocm_runtime.cpp for the canonical constant table).
    """
    h, w = y.shape
    y = np.ascontiguousarray(y, dtype=np.uint8)
    uv = np.ascontiguousarray(uv, dtype=np.uint8)
    lib = _load()
    out = np.empty((h, w, 4), dtype=np.uint8)
    if lib is not None:
        lib.ocm_nv12_to_rgba(y, uv, w, h, w, w, out, int(cs))
        return out
    # NumPy fallback, same spec
    kr_cr, kg_cb, kg_cr, kb_cb = _NV12_COEF[int(cs)]
    yp = (y.astype(np.int64) - 16) * _KY
    cb = uv[:, 0::2].astype(np.int64) - 128
    cr = uv[:, 1::2].astype(np.int64) - 128
    cb = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1)[:h, :w]
    cr = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1)[:h, :w]
    out[..., 0] = np.clip((yp + kr_cr * cr + 2048) >> 12, 0, 255)
    out[..., 1] = np.clip((yp + kg_cb * cb + kg_cr * cr + 2048) >> 12, 0, 255)
    out[..., 2] = np.clip((yp + kb_cb * cb + 2048) >> 12, 0, 255)
    out[..., 3] = 255
    return out


def yuv_planes_to_rgba(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray, cs: int = 2
) -> np.ndarray:
    """Planar limited-range YCbCr -> RGBA u8, any chroma subsampling.

    cb/cr may be (H, W), (H, W/2) [4:2:2] or (H/2, W/2) [4:2:0]; they are
    nearest-upsampled to full resolution, then converted through the SAME
    12-bit fixed-point inverse as nv12_to_rgba (csrc/ocm_runtime.cpp's
    canonical constant table), so every y4m subsampling lands on identical
    math.
    """
    h, w = y.shape
    kr_cr, kg_cb, kg_cr, kb_cb = _NV12_COEF[int(cs)]
    up = lambda c: np.repeat(
        np.repeat(c, -(-h // c.shape[0]), axis=0),
        -(-w // c.shape[1]), axis=1,
    )[:h, :w]
    yp = (y.astype(np.int64) - 16) * _KY
    cbf = up(cb.astype(np.int64) - 128)
    crf = up(cr.astype(np.int64) - 128)
    out = np.empty((h, w, 4), dtype=np.uint8)
    out[..., 0] = np.clip((yp + kr_cr * crf + 2048) >> 12, 0, 255)
    out[..., 1] = np.clip((yp + kg_cb * cbf + kg_cr * crf + 2048) >> 12, 0, 255)
    out[..., 2] = np.clip((yp + kb_cb * cbf + 2048) >> 12, 0, 255)
    out[..., 3] = 255
    return out


def deinterleave_rgba(rgba: np.ndarray) -> np.ndarray:
    """(H, W, 4) u8 -> planar (4, H, W) u8."""
    h, w = rgba.shape[:2]
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    lib = _load()
    out = np.empty((4, h, w), dtype=np.uint8)
    if lib is not None:
        lib.ocm_deinterleave_rgba(
            rgba, h * w, out[0], out[1], out[2], out[3]
        )
        return out
    return np.moveaxis(rgba, -1, 0).copy()


def pattern(kind: str, w: int, h: int, frame_idx: int = 0) -> np.ndarray:
    """Synthetic test frame: 'bars', 'ramp', or 'zoneplate' -> (H, W, 4) u8."""
    out = np.empty((h, w, 4), dtype=np.uint8)
    lib = _load()
    if lib is not None:
        fn = {
            "bars": lib.ocm_pattern_bars,
            "ramp": lib.ocm_pattern_ramp,
            "zoneplate": lib.ocm_pattern_zoneplate,
        }[kind]
        fn(out, w, h, frame_idx)
        return out
    # NumPy fallbacks (same definitions)
    if kind == "bars":
        bars = np.array(
            [
                [191, 191, 191], [191, 191, 0], [0, 191, 191], [0, 191, 0],
                [191, 0, 191], [191, 0, 0], [0, 0, 191], [0, 0, 0],
            ],
            dtype=np.uint8,
        )
        idx = (np.arange(w) * 8) // w
        out[..., :3] = bars[idx][None, :, :]
        out[..., 3] = 255
        out[frame_idx % h, :, :3] = 255
    elif kind == "ramp":
        v = (np.arange(w) * 256) // w
        t = ((np.arange(h) + frame_idx) * 256) // h
        out[..., 0] = np.clip(v, 0, 255)[None, :]
        out[..., 1] = np.clip((v[None, :] + t[:, None]) // 2, 0, 255)
        out[..., 2] = np.clip(t, 0, 255)[:, None]
        out[..., 3] = 255
    elif kind == "zoneplate":
        cx, cy = w / 2.0, h / 2.0
        k = 0.05 + 0.0005 * (frame_idx % 100)
        xx = np.arange(w) - cx
        yy = np.arange(h) - cy
        r2 = xx[None, :] ** 2 + yy[:, None] ** 2
        v = (127.5 + 127.5 * np.cos(k * r2 / 100.0)).astype(np.int32)
        out[..., 0] = out[..., 1] = out[..., 2] = np.clip(v, 0, 255)
        out[..., 3] = 255
    else:
        raise ValueError(f"unknown pattern {kind!r}")
    return out


class NativeFrameQueue:
    """Bounded drop-on-full queue backed by the C++ runtime (falls back to
    pipeline.queue.FrameQueue semantics in pure Python)."""

    def __init__(self, depth: int, frame_shape: tuple[int, ...]):
        self.frame_shape = tuple(frame_shape)
        self.frame_bytes = int(np.prod(frame_shape))
        self._closed = False
        self._lib = _load()
        if self._lib is not None:
            self._q = self._lib.ocm_queue_create(depth, self.frame_bytes)
            self._py = None
        else:
            from ..pipeline.queue import FrameQueue

            self._q = None
            self._py = FrameQueue(depth)

    @property
    def is_native(self) -> bool:
        return self._q is not None

    def push(self, frame: np.ndarray, tag=None) -> bool:
        """Enqueue a copy of ``frame``; False when full or closed.  ``tag``
        is taken for the object queue's sake and dropped: this queue carries
        frames only, so :meth:`pop_tagged` gives None for it."""
        if self._py is not None:
            return self._py.push(np.ascontiguousarray(frame, dtype=np.uint8))
        buf = np.ascontiguousarray(frame, dtype=np.uint8)
        if buf.nbytes != self.frame_bytes:
            # the C side copies frame_bytes unconditionally — an undersized
            # buffer would be an out-of-bounds read across the ABI
            raise ValueError(
                f"frame has {buf.nbytes} bytes, queue expects "
                f"{self.frame_bytes} (shape {self.frame_shape})"
            )
        return bool(
            self._lib.ocm_queue_push(self._q, buf.ctypes.data_as(ctypes.c_char_p))
        )

    def pop(self, timeout: float = 0.1) -> Optional[np.ndarray]:
        if self._py is not None:
            return self._py.pop(timeout)
        out = np.empty(self.frame_shape, dtype=np.uint8)
        ok = self._lib.ocm_queue_pop(
            self._q, out.ctypes.data_as(ctypes.c_char_p), float(timeout)
        )
        return out if ok else None

    def pop_tagged(self, timeout: float = 0.1) -> tuple[Optional[np.ndarray], None]:
        return self.pop(timeout), None

    def close(self) -> None:
        self._closed = True
        if self._py is not None:
            self._py.close()
        else:
            self._lib.ocm_queue_close(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    def __len__(self) -> int:
        if self._py is not None:
            return len(self._py)
        return int(self._lib.ocm_queue_size(self._q))

    @property
    def n_pushed(self) -> int:
        if self._py is not None:
            return self._py.n_pushed
        return int(self._lib.ocm_queue_pushed(self._q))

    @property
    def n_dropped(self) -> int:
        if self._py is not None:
            return self._py.n_dropped
        return int(self._lib.ocm_queue_dropped(self._q))

    def __del__(self):
        try:
            if self._q is not None and self._lib is not None:
                self._lib.ocm_queue_destroy(self._q)
                self._q = None
        except Exception:
            pass


class NativeFileReader:
    """C++ producer thread: reads raw RGBA or NV12 frames from a file,
    converts off the Python thread, and pushes into a NativeFrameQueue with
    drop-on-full backpressure (the native twin of the reference's capture
    producer, src/common.c:223-333).  Requires the native runtime.
    """

    FORMAT_RGBA = 0
    FORMAT_NV12 = 1

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        queue: NativeFrameQueue,
        fmt: int = FORMAT_RGBA,
        cs: int = 2,
        loop: bool = False,
        fps: float = 0.0,
    ):
        lib = _load()
        if lib is None or not queue.is_native:
            raise RuntimeError("native runtime unavailable")
        if tuple(queue.frame_shape) != (height, width, 4):
            raise ValueError("queue frame shape must be (height, width, 4)")
        self._lib = lib
        # hold the queue OBJECT, not just its raw pointer: the C++ reader
        # thread pushes into it, so the queue must outlive the reader —
        # our __del__ joins the thread before the queue can be destroyed
        self._queue = queue
        self._r = lib.ocm_reader_start(
            str(path).encode(), width, height, int(fmt), int(cs),
            queue._q, int(loop), float(fps),
        )

    @property
    def frames_read(self) -> int:
        return int(self._lib.ocm_reader_frames_read(self._r))

    @property
    def finished(self) -> bool:
        return bool(self._lib.ocm_reader_finished(self._r))

    def stop(self) -> None:
        if self._r is not None:
            self._lib.ocm_reader_stop(self._r)
            self._r = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
