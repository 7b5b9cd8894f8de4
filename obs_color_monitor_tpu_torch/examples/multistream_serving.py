"""Multi-stream serving: batch data-parallel scope analysis over a mesh.

Counterpart of ``examples/multistream_serving.py``.  N synthetic streams go
through ``parallel.batch_analyze`` each frame; every rank of the mesh
analyzes its slice of the batch and prints its streams' summaries.  One
process makes a one-rank mesh; under torchrun each rank takes one card:

    python -m obs_color_monitor_tpu_torch.examples.multistream_serving --streams 8
    torchrun --nproc-per-node 4 -m obs_color_monitor_tpu_torch.examples.multistream_serving
    python -m obs_color_monitor_tpu_torch.examples.multistream_serving --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ._common import add_device, check_device, join_group_from_env, leave_group, size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--frames", type=int, default=8)
    add_device(ap)
    args = ap.parse_args(argv)
    if not check_device(args.device):
        return 2
    import torch

    from ..parallel import batch_analyze, make_mesh
    from ..runtime import native

    w, h = size(args.size)
    join_group_from_env(args.device)
    try:
        mesh = make_mesh(device=args.device)
        n, r = mesh.size(), mesh.get_local_rank()
        if args.streams % n:
            raise SystemExit(f"--streams {args.streams} is not divisible by the mesh's {n} ranks")
        k = args.streams // n
        print(f"mesh: {n} rank{'s' if n > 1 else ''} on {args.device}; {args.streams} streams "
              f"{w}x{h}, streams {r * k}..{r * k + k - 1} on rank {r}", flush=True)
        kinds = ["bars", "ramp", "zoneplate"]
        for it in range(args.frames):
            frames = np.stack([native.pattern(kinds[s % 3], w, h, it)
                               for s in range(args.streams)])
            t0 = time.perf_counter()
            vs, hi, wv = batch_analyze(frames, mesh, cs=2)
            if vs.is_cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if it == args.frames - 1:
                vs, hi = vs.cpu().numpy(), hi.cpu().numpy()
                for i in range(k):
                    s = r * k + i
                    print(f"stream {s} ({kinds[s % 3]:9s}): R-peak={int(hi[i][0].argmax()):3d} "
                          f"vectorscope-occupancy={int((vs[i] > 0).sum())}")
            print(f"frame {it}: {k} streams analyzed on rank {r} in {dt * 1e3:.1f} ms "
                  "(host clock, upload included)", flush=True)
    finally:
        leave_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
