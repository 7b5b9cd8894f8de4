"""A PipelineDriver feeding a Dock, every frame delivered.

Counterpart of ``examples/driver_pipeline.py``.  The producer pushes frames
(packed RGBA, or NV12 wire planes with ``--nv12``); the driver's worker
thread runs each through the Dock (on a card the settled frame replays one
captured graph) and hands the panel to ``on_panel``, the sink.  The queue
drops on full: ``push_*`` returns False and the frame is not taken.  This
example retries a rejected push until the worker has room (the JAX
example's comment says "retry" but drops the frame), so every frame is
processed.

    python -m obs_color_monitor_tpu_torch.examples.driver_pipeline --frames 24 --size 320x180
    python -m obs_color_monitor_tpu_torch.examples.driver_pipeline --device cpu --nv12
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ._common import add_device, check_device, size

RETRY_S = 0.002
RETRY_LIMIT_S = 60.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="320x180")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--queue-depth", type=int, default=3)
    ap.add_argument("--nv12", action="store_true",
                    help="push raw NV12 wire planes instead of packed RGBA")
    add_device(ap)
    args = ap.parse_args(argv)
    if not check_device(args.device):
        return 2
    from ..config import DockConfig, ROIConfig
    from ..models import Dock
    from ..pipeline import PipelineDriver
    from ..runtime import native

    w, h = size(args.size)
    dock = Dock(DockConfig(), roi=ROIConfig(interleave=0, target_scale=1), device=args.device)
    fetched = []

    def sink(panel) -> None:
        # runs on the worker thread; a deployment encodes or publishes here
        fetched.append(tuple(panel.shape))

    drv = PipelineDriver(dock=dock, on_panel=sink, queue_depth=args.queue_depth)
    drv.start()
    retries = 0
    t0 = time.perf_counter()
    try:
        for i in range(args.frames):
            if args.nv12:
                # one contiguous NV12 buffer per frame (the wire's shape): y
                # and uv are adjacent views of it, uploaded together
                buf = np.random.default_rng(i).integers(0, 256, (h * 3 // 2, w), np.uint8)
                push = lambda: drv.push_nv12(buf[:h], buf[h:])
            else:
                frame = native.pattern("ramp", w, h, i)
                push = lambda: drv.push_frame(frame)
            deadline = time.perf_counter() + RETRY_LIMIT_S
            while not push():  # queue full: the frame was not taken, push it again
                if time.perf_counter() > deadline:
                    raise SystemExit(f"frame {i}: the queue stayed full for {RETRY_LIMIT_S} s")
                retries += 1
                time.sleep(RETRY_S)
        drv.flush()
    finally:
        drv.stop()
    dt = time.perf_counter() - t0

    st = drv.stats
    print(f"driver stats: {st}")
    print(f"rejected pushes retried: {retries}; frames pushed {args.frames}, processed "
          f"{st['processed']}")
    print(f"panels sunk: {len(fetched)} x {fetched[-1] if fetched else None}")
    print(f"histogram occupied levels: {int((dock.histogram.counts() > 0).sum())}")
    print(f"wall: {dt * 1e3 / max(st['processed'], 1):.2f} ms/frame ({st['processed']} frames, "
          "host clock)")
    if st["errors"] or st["processed"] != args.frames or len(fetched) != args.frames:
        raise SystemExit("a frame was lost or failed")
    print("DRIVER_PIPELINE_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
