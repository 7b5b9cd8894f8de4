"""Drag a region of interest every frame, served by one captured step.

Counterpart of ``examples/interactive_roi_drag.py``.  The rect changes on
every tick, as the reference's move-drag pushes it; the Dock runs each
moving frame through the dynamic-ROI dock step
(``make_dock_step(dynamic_roi=True)``), which takes the rect as a (4,)
int32 tensor in device memory.  So the whole drag is one program: on a
card one captured CUDA graph replayed for every rect, on the CPU the same
sequence of operations at the same shapes for every rect.  The live mean
level of the analyzed crop follows the ramp, so the statistics follow the
rect.

    python -m obs_color_monitor_tpu_torch.examples.interactive_roi_drag
    python -m obs_color_monitor_tpu_torch.examples.interactive_roi_drag --device cpu --size 64x48
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

from ._common import add_device, check_device, size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="320x180")
    ap.add_argument("--steps", type=int, default=12, help="drag positions")
    ap.add_argument("--out", default="", help="optional final panel PNG")
    add_device(ap)
    args = ap.parse_args(argv)
    if not check_device(args.device):
        return 2
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..config import DockConfig, ROIConfig
    from ..models import Dock
    from ..runtime import native

    class OpLog(TorchDispatchMode):
        """Every operation dispatched, with its output shapes."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else [out]
            self.ops.append((str(func), tuple(tuple(o.shape) for o in outs
                                              if hasattr(o, "shape"))))
            return out

    w, h = size(args.size)
    dock = Dock(DockConfig(width=128, height=784), roi=ROIConfig(target_scale=2, interleave=0),
                device=args.device)
    # a ramp: brightness grows to the right, so the live mean level of the
    # analyzed crop says which region the moving rect covers
    frame = native.pattern("ramp", w, h, 0)
    for _ in range(3):  # the settled stream route on the full capture
        dock.push_frame(frame)
        dock.render_async(128, 784)

    def live_mean() -> float:
        counts = dock.scopes["histogram"].counts()
        c = np.asarray(counts[0], np.float64)
        return float((c * np.arange(256)).sum() / max(c.sum(), 1))

    print(f"full capture: mean level = {live_mean():.1f}")
    sw, sh = w // 2, h // 2  # the scaled capture (target_scale=2)
    wsel, hsel = max(sw // 4, 1), max(sh - 8, 1)
    travel = max(sw - wsel - 8, 0)
    steps, op_seqs = set(), set()
    t0 = time.perf_counter()
    for i in range(args.steps):
        x0 = 4 + travel * i // max(args.steps - 1, 1)
        dock.hub.set_roi(x0, 4, x0 + wsel, 4 + hsel)
        dock.push_frame(frame)
        # on the CPU every operation is logged; a card replays a graph
        log = OpLog() if dock.device.type == "cpu" else contextlib.nullcontext()
        with log:
            dock.render_async(128, 784)
        if i and isinstance(log, OpLog):  # the first moving frame builds the step
            op_seqs.add(tuple(log.ops))
        steps.add(id(dock._device_step))
        print(f"drag step {i:2d}: rect x0={x0:3d}  live crop mean={live_mean():6.1f}")
    dt = time.perf_counter() - t0
    print(f"{args.steps}-position drag in {dt:.2f} s (host clock); "
          f"dynamic-rect steps built for the drag: {len(steps)}")
    if dock.device.type == "cuda":
        print(f"dynamic-rect graphs captured for the drag: {dock._device_step.graphs}")
    else:
        print(f"dynamic-rect op sequences for the drag: {len(op_seqs)} "
              f"(drag steps 1..{args.steps - 1}, {len(next(iter(op_seqs), ()))} ops each)")
    if args.out:
        from ..utils.image_io import write_png

        write_png(args.out, dock.render(128, 784))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
