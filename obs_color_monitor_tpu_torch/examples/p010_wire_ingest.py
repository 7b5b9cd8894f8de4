"""P010 wire ingest: the untouched 16-bit wire planes decoded on the device.

Counterpart of ``examples/p010_wire_ingest.py``.  An HDR capture stack hands
over P010 buffers (10-bit 4:2:0, 16-bit little-endian words, the samples in
the top bits).  The host only reads each frame and uploads its y and uv
planes; the round-shift to the 8-bit monitoring domain and the YUV to RGB
decode run on the device, in kernel K5, inside the Dock's stream step.

    python -m obs_color_monitor_tpu_torch.examples.p010_wire_ingest --size 1920x1080
    python -m obs_color_monitor_tpu_torch.examples.p010_wire_ingest --device cpu --size 64x48

The demo clip is written to ``--clip``, or to a temporary file that is
removed afterwards.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from ._common import add_device, check_device, size


def write_demo_p010(path: str, w: int, h: int, n: int) -> None:
    """A moving 10-bit luma ramp with neutral chroma, MSB-aligned."""
    with open(path, "wb") as f:
        for i in range(n):
            col = (np.arange(w) * 876 // max(w - 1, 1) + 64 + 8 * i) % 940
            y10 = np.broadcast_to(col.astype(np.uint16), (h, w))
            f.write((y10 << 6).astype("<u2").tobytes())
            f.write(np.full((h // 2, w), 512 << 6, "<u2").tobytes())


def run(clip: str, w: int, h: int, frames: int, device: str) -> None:
    import torch

    from ..config import DockConfig, ROIConfig
    from ..models import Dock
    from ..pipeline.ingest import NV12Source

    write_demo_p010(clip, w, h, frames)
    src = NV12Source(clip, w, h, cs=2, bits=10, msb_aligned=True)
    print(f"source: {os.path.basename(clip)} {w}x{h}, {src.n_frames} frames, "
          f"device shift={src.nv12_shift}")
    dock = Dock(DockConfig(show_roi=False, show_focuspeaking=True),
                roi=ROIConfig(interleave=0, target_scale=1), device=device)
    t0 = time.perf_counter()
    for y16, uv16 in src.frames_nv12():
        # the raw u16 wire planes in; shift and decode run in the stream step
        dock.push_nv12(y16, uv16, cs=src.cs, shift=src.nv12_shift)
        dock.render_async()
    if dock.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"{src.n_frames} frames in {dt:.3f} s (host clock: disk read, upload and the first "
          "frames' set-up included)")
    hist = np.asarray(dock.histogram.counts())
    total = int(hist[0].sum())
    print(f"luma histogram occupancy: {int((hist[0] > 0).sum())} levels, sum {total} "
          f"(= {w}x{h} = {w * h})")
    if total != w * h:
        raise SystemExit("the histogram does not count every pixel")
    print("OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--clip", default="", help="where to write the demo clip")
    add_device(ap)
    args = ap.parse_args(argv)
    if not check_device(args.device):
        return 2
    w, h = size(args.size)
    if args.clip:
        run(args.clip, w, h, args.frames, args.device)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            run(os.path.join(tmp, "demo.p010"), w, h, args.frames, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
