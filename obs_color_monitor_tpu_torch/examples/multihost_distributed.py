"""Multi-host deployment: ranks of a torch.distributed group, each feeding
its own streams and its own rows of one shared frame.

Counterpart of ``examples/multihost_distributed.py``.  Every rank (a
process with one card, on any host) ingests only its own data:

* its streams, through ``make_batched_step(mesh=)`` (batch data-parallel,
  no collective: per-stream results stay on the rank);
* its rows of one large frame, through ``parallel.spatial_pipeline`` in
  host-local form: the statistics merged over the group by one all-reduce,
  focus peaking's boundary rows exchanged with the neighbouring ranks.

Launch one process per card with torchrun (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` come from it):

    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-endpoint HOST:PORT \\
        -m obs_color_monitor_tpu_torch.examples.multihost_distributed

or simulate N hosts on the CPU, N gloo ranks as processes of this machine:

    python -m obs_color_monitor_tpu_torch.examples.multihost_distributed --simulate --ranks 2
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np

from ._common import add_device, check_device, join_group_from_env, leave_group, size

SIM_TIMEOUT_S = 300


def _simulate(args) -> int:
    """Run ``args.ranks`` copies of this module as gloo ranks on the CPU and
    relay their output; non-zero if any failed."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    argv = [sys.executable, "-m", __spec__.name, "--device", "cpu", "--size", args.size,
            "--streams_per_host", str(args.streams_per_host)]
    procs = []
    for r in range(args.ranks):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.ranks), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      env=env))
    rc = 0
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=SIM_TIMEOUT_S)
            sys.stdout.write(out.decode(errors="replace"))
            if p.returncode:
                print(f"rank {r} failed with exit code {p.returncode}", flush=True)
                rc = 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return rc


def _shared_frame(w: int, h: int) -> np.ndarray:
    """The large frame every rank knows how to make (each makes only its
    rows of it): a ramp with bright rows, alpha 255."""
    from ..runtime import native

    f = native.pattern("ramp", w, h, 0)
    f[::8, :, :3] = 255
    return f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams_per_host", type=int, default=2)
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--simulate", action="store_true",
                    help="spawn --ranks gloo ranks on the CPU, one process each")
    ap.add_argument("--ranks", type=int, default=2)
    add_device(ap)
    args = ap.parse_args(argv)
    if args.simulate:
        return _simulate(args)
    if not check_device(args.device):
        return 2
    import torch

    from .. import Colorspace, make_batched_step
    from ..golden.reference import peaking_threshold_fixed
    from ..parallel import SPATIAL_AXIS, make_mesh, mesh_device, spatial_pipeline

    w, h = size(args.size)
    join_group_from_env(args.device)
    try:
        mesh = make_mesh(device=args.device)
        rows = make_mesh(axis=SPATIAL_AXIS, device=args.device)
        n, r = mesh.size(), mesh.get_local_rank()
        dev = mesh_device(mesh)

        # batch data-parallel: this host's own streams, B local
        b = max(args.streams_per_host, 1)
        rng = np.random.default_rng(r)
        frames = rng.integers(0, 256, (b, h, w, 4), dtype=np.uint8)
        frames[..., 3] = 255
        step = make_batched_step(h, w, mesh=mesh, cs=Colorspace.BT709, scale=2)
        out = step(frames, np.zeros(b, np.float32))  # host arrays, copied to this rank's card
        occupied = [int((v > 0).sum()) for v in out.vs_counts.cpu().numpy()]
        print(f"host {r}/{n}: {dev}, batch {b} local of {b * n} global, vectorscope occupied "
              f"bins per local stream: {occupied}", flush=True)

        # one frame, rows sharded: this host makes and uploads only its rows
        hh = h - h % n
        hb = hh // n
        block = _shared_frame(w, hh)[r * hb:(r + 1) * hb]
        vs, hi, wv, zb, fc, fp = spatial_pipeline(
            block, rows, cs=2, tm=1.5, peak_th=peaking_threshold_fixed(0.05), local=True)
        hist_sum = int(hi[0].to(torch.int64).sum())
        peaks = int((fp != torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(block, -1, 0))).to(dev)).any(0).sum())
        print(f"host {r}/{n}: spatial rows {r * hb}..{(r + 1) * hb - 1} of {hh}: merged "
              f"histogram sum {hist_sum} (= {w}x{hh}: {hist_sum == w * hh}), vectorscope "
              f"occupied bins {int((vs > 0).sum())}, focus-peaking pixels in my rows {peaks}",
              flush=True)
        if hist_sum != w * hh:
            raise SystemExit("the merged histogram does not count the whole frame")
        print(f"MULTIHOST_OK rank {r}", flush=True)
    finally:
        leave_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
