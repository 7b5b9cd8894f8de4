"""One rank of the port's multi-process mesh test (``tests/test_torch_parallel.py``).

Run as ``python _torch_mesh_worker.py <rank> <world size> <port> <out dir>``:
the ranks join a gloo group on localhost, run every case of
``obs_color_monitor_tpu_torch.parallel`` on the CPU (the all-reduce merge
and the focus-peaking halo cross the process boundary) and write this
rank's outputs to ``<out dir>/rank<r>.npz``; the parent compares them with
JAX's ``parallel`` functions and with the golden model.  The inputs are
made here from seeds, by :func:`inputs`, which the parent calls too.

Every public call goes through the cached device steps (``mesh._mesh_step``);
the worker also records how many steps each path cached and logs the
operations each step dispatches over four calls (:func:`one_program`), as
``tests/test_torch_one_program.py`` does for the single-device steps.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

H, W = 64, 48  # divisible by every mesh size tested: 1, 2, 4, 8
STEP_B, STEP_H, STEP_W = 8, 32, 48
CLOCKS = (3.25, 0.3, 1000.37)
PIPE_TH = dict(th_low=0.5, th_high=1.0)
HOST_READS = ("_local_scalar_dense", "lift_fresh")
STEP_PATHS = ("batch_analyze", "spatial_analyze", "spatial_pipeline")


def peak_th() -> int:
    from obs_color_monitor_tpu_torch.golden.reference import peaking_threshold_fixed

    return peaking_threshold_fixed(0.05)


def inputs() -> dict:
    """Every host input of the cases, from fixed seeds."""
    rng = np.random.default_rng(0xA11)
    batch = rng.integers(0, 256, (8, 32, 48, 4), dtype=np.uint8)
    batch[..., 3] = 255
    batch[1, :4, :, 3] = 0  # alpha-0 pixels: skipped by the RGB waveform only

    # one (u, v) bin over 255 only after the merge: 64 x 6 grey pixels,
    # 192 a rank at n = 2 and 96 at n = 4
    gray = rng.integers(0, 256, (H, 40, 4), dtype=np.uint8)
    gray[..., 3] = 255
    gray[:, :6, :3] = 128

    # bright rows on both sides of every boundary of 2, 4 and 8 row blocks
    pipe = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    pipe[..., 3] = 255
    pipe[rng.random((H, W)) < 0.05, 3] = 0
    pipe[::8, :, :3] = 255
    pipe[7::8, 3:, :3] = 230

    # the YUV family: alpha 0 everywhere (never skipped), a grey block and
    # constant columns (a vectorscope bin over 255 after the merge)
    yuv = rng.integers(0, 256, (H, 40, 4), dtype=np.uint8)
    yuv[..., 3] = 0
    yuv[:, :8, :3] = 128
    yuv[:, 8:16, :3] = yuv[:1, 8:16, :3]

    # tests/_multihost_worker.py's frame
    r7 = np.random.default_rng(7)
    host = r7.integers(0, 256, size=(H, 40, 4), dtype=np.uint8)
    host[..., 3] = 255
    host[r7.random((H, 40)) < 0.05, 3] = 0
    host[:, :10, :3] = 128
    host[::16, :, :3] = 255

    step = rng.integers(0, 256, (STEP_B, STEP_H, STEP_W, 4), dtype=np.uint8)
    step[..., 3] = np.where(rng.random((STEP_B, STEP_H, STEP_W)) < 0.1, 0, 255)
    step_tms = (0.5 + 1.25 * np.arange(STEP_B)).astype(np.float32)
    return dict(batch=batch, gray=gray, pipe=pipe, yuv=yuv, host=host, step=step,
                step_tms=step_tms, batch_yuv=np.stack([yuv] * 4 + [gray] * 4))


def run_cases(mesh_b, mesh_r, device: str = "cpu") -> dict:
    """Every case on this rank: {name: tuple of numpy outputs}."""
    import torch

    from obs_color_monitor_tpu_torch import Colorspace, make_batched_step
    from obs_color_monitor_tpu_torch import parallel as par

    x = inputs()
    pf = peak_th()
    host = lambda ts: tuple(t.cpu().numpy() for t in ts)
    n, r = mesh_r.size(), mesh_r.get_local_rank()
    out = {
        "batch_rgb": host(par.batch_analyze(x["batch"], mesh_b, cs=2)),
        "batch_yuv": host(par.batch_analyze(x["batch_yuv"], mesh_b, cs=1, components="yuv")),
        "spatial_rgb": host(par.spatial_analyze(x["gray"], mesh_r, cs=1)),
        "spatial_yuv": host(par.spatial_analyze(x["yuv"], mesh_r, cs=1, components="yuv")),
        "pipe_yuv": host(par.spatial_pipeline(x["yuv"], mesh_r, cs=1, components="yuv",
                                              peak_th=pf)),
    }
    for i, tm in enumerate(CLOCKS):
        out[f"pipe_tm{i}"] = host(par.spatial_pipeline(
            x["pipe"], mesh_r, cs=2, tm=tm, peak_th=pf, **PIPE_TH))
    # the clock as a 0-d float32 tensor
    out["pipe_tm0_tensor"] = host(par.spatial_pipeline(
        x["pipe"], mesh_r, cs=2, tm=torch.tensor(CLOCKS[0]), peak_th=pf, **PIPE_TH))

    # host-local ingest: each rank holds only its own rows / frames
    hb = H // n
    block = x["host"][r * hb:(r + 1) * hb]
    out["local_analyze"] = host(par.spatial_analyze(block, mesh_r, cs=2, local=True))
    out["local_pipe"] = host(par.spatial_pipeline(
        block, mesh_r, cs=2, tm=3.25, th_low=0.5, th_high=0.9, peak_th=pf, local=True))
    k = x["batch"].shape[0] // n
    out["local_batch"] = host(par.batch_analyze(x["batch"][r * k:(r + 1) * k], mesh_b, cs=2,
                                                local=True))

    step = make_batched_step(STEP_H, STEP_W, mesh=mesh_b, cs=Colorspace.BT709, scale=1)
    frames = par.shard_batch(x["step"], mesh_b)
    tms = par.shard_batch(x["step_tms"], mesh_b)
    out["step"] = tuple(v for v in step(frames, tms).to_numpy().values())

    # every argument error raises ValueError
    raised = []
    for call in (
        lambda: par.spatial_analyze(x["gray"][:H - 1], mesh_r, cs=1),
        lambda: par.spatial_pipeline(x["gray"][:H - 1], mesh_r, cs=1),
        lambda: par.batch_analyze(x["batch"][:n * 2 - 1], mesh_b, cs=2),
        lambda: par.shard_batch(x["batch"][:n * 2 - 1], mesh_b),
        lambda: par.spatial_analyze(x["gray"], mesh_r, cs=1, components="rgba"),
        lambda: par.batch_analyze(x["batch"], mesh_b, cs=1, backend="pallas"),
        lambda: par.make_mesh(n + 1, device=device),
    ):
        try:
            call()
            raised.append(0)
        except ValueError:
            raised.append(1)
    out["raised"] = (np.asarray(raised),)

    # the steps the cases cached, by path: batch (cs 2 RGB, cs 1 YUV), spatial
    # (cs 1 RGB, cs 1 YUV, cs 2 RGB), pipeline (the YUV case, the clock cases
    # with a float or a tensor clock, the local case); failed calls cache none
    from obs_color_monitor_tpu_torch.parallel import mesh as pm

    keys = pm._STEPS[mesh_r.get_group()]
    out["steps"] = (np.asarray([sum(k[0] == p for k in keys) for p in STEP_PATHS]),)
    out["one_program"] = (np.asarray(one_program(mesh_b, mesh_r)),)
    return out


def log_ops(calls) -> list:
    """The operations each of ``calls`` (functions of no argument)
    dispatches, with their output shapes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else [out]
            self.ops.append((str(func), tuple(tuple(o.shape) for o in outs
                                              if isinstance(o, torch.Tensor))))
            return out

    logs = []
    for call in calls:
        with OpLog() as log:
            call()
        logs.append(log.ops)
    return logs


def step_calls(mesh_b, mesh_r) -> dict:
    """{path: four calls of its cached step}, each on another block (and
    the pipeline at another clock)."""
    from obs_color_monitor_tpu_torch.parallel import mesh as pm

    x = inputs()
    pf = peak_th()
    calls = {}
    for path, mesh, key, kw in (
        ("batch_analyze", mesh_b, "batch", dict(cs=2)),
        ("spatial_analyze", mesh_r, "yuv", dict(cs=1, components="yuv")),
        ("spatial_pipeline", mesh_r, "pipe", dict(cs=2, peak_th=pf, **PIPE_TH)),
    ):
        step = pm._mesh_step(path, mesh, **kw)
        shard = pm.shard_batch if path == "batch_analyze" else pm.shard_rows
        blocks = [shard(np.roll(x[key], 5 * i, axis=-2), mesh) for i in range(4)]
        clocks = [(tm,) for tm in CLOCKS + (7.5,)] if path == "spatial_pipeline" else [()] * 4
        calls[path] = [lambda step=step, b=b, c=c: step(b, *c) for b, c in zip(blocks, clocks)]
    return calls


def program_flags(path: str, logs: list) -> list:
    """[the same operations at the same shapes from the second call on, no
    host read in any call after the first, a collective in every call (for
    ``batch_analyze``: in none)] of a step's op logs, 1 for true."""
    later = [op for ops in logs[1:] for op, _ in ops]
    c10d = [any(op.startswith("c10d.") for op, _ in ops) for ops in logs]
    return [int(all(ops == logs[1] for ops in logs[2:])),
            int(not any(h in op for op in later for h in HOST_READS)),
            int(all(c10d) if path != "batch_analyze" else not any(c10d))]


def one_program(mesh_b, mesh_r) -> list:
    """:func:`program_flags` of each path of :data:`STEP_PATHS`."""
    return [program_flags(path, log_ops(calls))
            for path, calls in step_calls(mesh_b, mesh_r).items()]


def main() -> None:
    rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        from obs_color_monitor_tpu_torch import parallel as par

        mesh_b = par.make_mesh(world, device="cpu")
        mesh_r = par.make_mesh(world, axis=par.SPATIAL_AXIS, device="cpu")
        out = run_cases(mesh_b, mesh_r)
        np.savez(Path(out_dir) / f"rank{rank}.npz",
                 **{f"{k}/{i}": v for k, vs in out.items() for i, v in enumerate(vs)})
    finally:
        dist.destroy_process_group()
    print(f"TORCH_MESH_OK rank {rank}", flush=True)


if __name__ == "__main__":
    main()
