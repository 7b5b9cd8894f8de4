"""Minimal image IO: PNG write (pure-python fallback) + LUT loading
(counterpart of ``obs_color_monitor_tpu/utils/image_io.py``, a copy).

The reference loads LUT / graticule images through gs_image_file (stb-based,
reference src/zebra.c:177-207).  Here PIL is used when present, with a
dependency-free zlib PNG writer as fallback.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def encode_png(rgba: np.ndarray) -> bytes:
    """(H, W, 3|4) u8 -> PNG bytes (dependency-free zlib encoder)."""
    rgba = np.asarray(rgba, dtype=np.uint8)
    h, w = rgba.shape[:2]
    color_type = 6 if rgba.shape[2] == 4 else 2

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str | Path, rgba: np.ndarray) -> None:
    """Write (H, W, 4) or (H, W, 3) uint8 as PNG."""
    rgba = np.asarray(rgba, dtype=np.uint8)
    try:
        from PIL import Image

        Image.fromarray(rgba).save(str(path))
        return
    except Exception:
        pass
    Path(path).write_bytes(encode_png(rgba))


def encode_frame(rgba: np.ndarray, quality: int = 80) -> tuple[bytes, str]:
    """(H, W, 3|4) u8 -> (encoded bytes, mime type) for streaming sinks.

    JPEG via PIL when present (small + fast, what MJPEG viewers expect);
    falls back to the dependency-free PNG writer (multipart/x-mixed-replace
    carries any image type, browsers render both).
    """
    rgba = np.asarray(rgba, dtype=np.uint8)
    try:
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgba[..., :3]).save(buf, "JPEG", quality=quality)
        return buf.getvalue(), "image/jpeg"
    except Exception:
        return encode_png(rgba), "image/png"


def load_image_rgba(path: str | Path) -> np.ndarray:
    """Load any image as (H, W, 4) uint8 (LUT files etc.)."""
    from PIL import Image

    img = Image.open(str(path)).convert("RGBA")
    return np.asarray(img, dtype=np.uint8)


def load_lut(path: str | Path) -> np.ndarray:
    """Load a 1-D false-color LUT image: uses the first row, shape (N, 4)
    (the reference samples lut at (y, 0.5), data/falsecolor.effect:36-37)."""
    img = load_image_rgba(path)
    return img[img.shape[0] // 2]
