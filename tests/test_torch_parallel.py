"""The port's ``parallel`` (torch.distributed, gloo on the CPU) against JAX's
``parallel`` on the suite's virtual CPU devices and against the golden
model, bit for bit.

* World size 1, in this process: ``tests/test_parallel.py``'s six cases,
  the port at one rank against JAX's functions on 8 devices.  The group is
  destroyed when the module ends (other files run in the same worker).
* 2 and 4 ranks, each a process (``tests/_torch_mesh_worker.py``), which
  write their outputs to ``.npz`` files: every case against JAX's function
  on ``make_mesh(n)`` and against golden, including a vectorscope bin that
  saturates only after the merge, bright rows on both sides of every shard
  boundary at three zebra clocks, the YUV family, host-local ingest and
  ``make_batched_step(mesh=)``.  Each process has a group timeout and a
  subprocess timeout, so a dead rank fails the test instead of hanging it.
* The argument errors, at one rank here and at 2 and 4 in the workers."""

import functools
import importlib.util
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu import parallel as jpar
from obs_color_monitor_tpu.api import make_batched_step as jax_make_batched_step
from obs_color_monitor_tpu.colorspace import Colorspace as JaxColorspace
from obs_color_monitor_tpu.config import Components
from obs_color_monitor_tpu_torch import Colorspace, ScopeOutputs, make_batched_step
from obs_color_monitor_tpu_torch import parallel as par

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_torch_mesh_worker", TESTS / "_torch_mesh_worker.py")
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

X = worker.inputs()
PF = worker.peak_th()
H, W = worker.H, worker.W
RANKS = (2, 4)
TIMEOUT_S = 240

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _np(ts) -> tuple:
    return tuple(np.asarray(t) for t in ts)


def _rgba(p) -> np.ndarray:
    return np.moveaxis(np.asarray(p), 0, -1)


@functools.lru_cache(maxsize=None)
def jax_case(name: str, n: int) -> tuple:
    """JAX's result of a worker case on a mesh of n devices (all of it; the
    overlays of every row)."""
    mb, mr = jpar.make_mesh(n), jpar.make_mesh(n, axis="rows")
    pipe = dict(cs=2, peak_th=PF, **worker.PIPE_TH)
    if name in ("batch_rgb", "local_batch"):
        return _np(jpar.batch_analyze(X["batch"], mb, cs=2))
    if name == "batch_yuv":
        return _np(jpar.batch_analyze(X["batch_yuv"], mb, cs=1, components="yuv"))
    if name == "spatial_rgb":
        return _np(jpar.spatial_analyze(X["gray"], mr, cs=1))
    if name == "spatial_yuv":
        return _np(jpar.spatial_analyze(X["yuv"], mr, cs=1, components="yuv"))
    if name == "pipe_yuv":
        return _np(jpar.spatial_pipeline(X["yuv"], mr, cs=1, components="yuv", peak_th=PF))
    if name.startswith("pipe_tm"):
        tm = worker.CLOCKS[int(name[len("pipe_tm")])]
        return _np(jpar.spatial_pipeline(X["pipe"], mr, tm=tm, **pipe))
    if name == "local_analyze":
        return _np(jpar.spatial_analyze(X["host"], mr, cs=2))
    if name == "local_pipe":
        return _np(jpar.spatial_pipeline(X["host"], mr, cs=2, tm=3.25, th_low=0.5, th_high=0.9,
                                         peak_th=PF))
    if name == "step":
        sh = NamedSharding(mb, P("batch"))
        step = jax_make_batched_step(worker.STEP_H, worker.STEP_W, mesh=mb,
                                     cs=JaxColorspace.BT709, scale=1)
        out = step(jax.device_put(X["step"], sh), jax.device_put(X["step_tms"], sh))
        return tuple(np.asarray(getattr(out, k)) for k in ScopeOutputs._fields)
    raise KeyError(name)


def golden_stats(frame: np.ndarray, cs: int, yuv_family: bool = False) -> tuple:
    yuv = golden.rgb_to_yuv_u8(frame, JaxColorspace(cs))
    comp, data = (Components.YUV, yuv) if yuv_family else (Components.RGB, None)
    return (golden.vectorscope_counts(yuv), golden.histogram_counts(frame, data, comp),
            golden.waveform_counts(frame, data, comp))


def golden_overlays(frame, cs, tm, th_low, th_high) -> tuple:
    return (golden.zebra(frame, th_low, th_high, tm, JaxColorspace(cs)),
            golden.falsecolor(frame, JaxColorspace(cs)),
            golden.focus_peaking(frame, 0.05, (1.0, 0.0, 0.0, 1.0)))


def assert_same(got: tuple, want: tuple, what: str) -> None:
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        assert np.array_equal(g, w), (what, i)


# --------------------------------------------------------------------------
# world size 1, in process: tests/test_parallel.py's six cases
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meshes():
    """(batch mesh, rows mesh) over a world-size-1 gloo group, destroyed at
    the end of the module."""
    assert not dist.is_initialized()
    mb = par.make_mesh(device="cpu")
    mr = par.make_mesh(axis=par.SPATIAL_AXIS, device="cpu")
    yield mb, mr
    dist.destroy_process_group()


@requires_8
def test_batch_dp_bitexact(meshes, rng):
    frames = rng.integers(0, 256, size=(8, 32, 48, 4), dtype=np.uint8)
    frames[..., 3] = 255
    got = _np(par.batch_analyze(frames, meshes[0], cs=2))
    assert got[0].shape == (8, 256, 256) and got[1].dtype == np.uint32
    assert_same(got, _np(jpar.batch_analyze(frames, jpar.make_mesh(8), cs=2)), "vs JAX")
    for b in range(8):
        assert_same(tuple(o[b] for o in got), golden_stats(frames[b], 2), f"frame {b}")


@requires_8
def test_spatial_sharding_bitexact(meshes, rng):
    frame = rng.integers(0, 256, size=(64, 40, 4), dtype=np.uint8)
    frame[..., 3] = 255
    frame[:, :, :3] = 128
    got = _np(par.spatial_analyze(frame, meshes[1], cs=1))
    assert_same(got, _np(jpar.spatial_analyze(frame, jpar.make_mesh(8, axis="rows"), cs=1)),
                "vs JAX")
    want = golden_stats(frame, 1)
    assert want[0].max() == 255
    assert_same(got, want, "vs golden")


def test_spatial_sharding_requires_divisible(meshes):
    # one rank divides every height; the workers hold H % n != 0 at 2 and 4
    # ranks (test_ranks_raise_on_bad_arguments)
    frame = np.zeros((30, 16, 4), np.uint8)
    assert par.spatial_analyze(frame, meshes[1], cs=1)[0].shape == (256, 256)
    with pytest.raises(ValueError):
        par.make_mesh(8, device="cpu")
    with pytest.raises(ValueError):
        par.spatial_analyze(frame, meshes[1], cs=1, components="rgba")
    with pytest.raises(ValueError):
        par.spatial_pipeline(frame, meshes[1], cs=1, backend="xla")
    with pytest.raises(ValueError):
        par.batch_analyze(frame[None], meshes[0], cs=1, backend="pallas")
    with pytest.raises(ValueError):
        par.spatial_analyze(frame[..., :3], meshes[1], cs=1)


@requires_8
def test_batched_step_sharded(meshes, rng):
    frames = rng.integers(0, 256, (8, 32, 48, 4), dtype=np.uint8)
    frames[..., 3] = 255
    tms = np.zeros(8, np.float32)
    mesh = jpar.make_mesh(8)
    sh = NamedSharding(mesh, P("batch"))
    ref = jax_make_batched_step(32, 48, mesh=mesh, cs=JaxColorspace.BT709, scale=1)(
        jax.device_put(frames, sh), jax.device_put(tms, sh))
    step = make_batched_step(32, 48, mesh=meshes[0], cs=Colorspace.BT709, scale=1)
    out = step(par.shard_batch(frames, meshes[0]), par.shard_batch(tms, meshes[0])).to_numpy()
    assert out["vs_counts"].shape == (8, 256, 256)
    for k in ("vs_counts", "wv_counts", "hi_counts", "zebra", "falsecolor", "focuspeaking",
              "vectorscope", "waveform"):
        assert np.array_equal(out[k], np.asarray(getattr(ref, k))), k
    for b in range(0, 8, 3):
        yuv = golden.rgb_to_yuv_u8(frames[b], JaxColorspace.BT709)
        assert np.array_equal(out["vs_counts"][b], golden.vectorscope_counts(yuv))
        assert np.array_equal(out["hi_counts"][b],
                              golden.histogram_counts(frames[b], None, Components.RGB))


@requires_8
@pytest.mark.parametrize("tm", worker.CLOCKS)
def test_spatial_pipeline_bitexact(meshes, rng, tm):
    frame = rng.integers(0, 256, size=(64, 48, 4), dtype=np.uint8)
    frame[..., 3] = 255
    frame[rng.random((64, 48)) < 0.05, 3] = 0
    frame[::8, :, :3] = 255
    got = _np(par.spatial_pipeline(frame, meshes[1], cs=2, tm=tm, th_low=0.5, th_high=0.9,
                                   peak_th=PF))
    ref = _np(jpar.spatial_pipeline(frame, jpar.make_mesh(8, axis="rows"), cs=2, tm=tm,
                                    th_low=0.5, th_high=0.9, peak_th=PF))
    assert_same(got, ref, "vs JAX")
    assert_same(got[:3], golden_stats(frame, 2), "stats vs golden")
    assert_same(tuple(_rgba(p) for p in got[3:]), golden_overlays(frame, 2, tm, 0.5, 0.9),
                "overlays vs golden")


@requires_8
def test_yuv_family_sharded(meshes, rng):
    frame = rng.integers(0, 256, size=(64, 40, 4), dtype=np.uint8)
    frame[..., 3] = 0
    frame[:, :8, :3] = 128
    frame[:, 8:16, :3] = frame[:1, 8:16, :3]
    want = golden_stats(frame, 1, yuv_family=True)
    got = _np(par.spatial_analyze(frame, meshes[1], cs=1, components="yuv"))
    assert_same(got, want, "spatial vs golden")
    assert_same(got, _np(jpar.spatial_analyze(frame, jpar.make_mesh(8, axis="rows"), cs=1,
                                              components="yuv")), "spatial vs JAX")
    frames = np.stack([frame] * 8)
    vsb, hib, wvb = _np(par.batch_analyze(frames, meshes[0], cs=1, components="yuv"))
    assert np.array_equal(vsb[3], want[0]) and np.array_equal(wvb[5], want[2])
    assert np.array_equal(hib[2], want[1])
    full = _np(par.spatial_pipeline(frame, meshes[1], cs=1, components="yuv"))
    assert np.array_equal(full[2], got[2])


# --------------------------------------------------------------------------
# 2 and 4 ranks, one process each
# --------------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(n: int, out_dir: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent), OMP_NUM_THREADS="1")
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, str(TESTS / "_torch_mesh_worker.py"), str(r),
                              str(n), port, str(out_dir)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                             cwd=str(TESTS.parent))
            for r in range(n)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{n: [rank r's outputs by case]} for n in RANKS, every group run at
    once; a rank that fails or outlives the timeout fails every test."""
    procs = {n: _launch(n, tmp_path_factory.mktemp(f"ranks{n}")) for n in RANKS}
    outs = {}
    try:
        for n, ps in procs.items():
            for r, p in enumerate(ps):
                out, _ = p.communicate(timeout=TIMEOUT_S)
                text = out.decode(errors="replace")
                assert p.returncode == 0 and f"TORCH_MESH_OK rank {r}" in text, \
                    f"{n} ranks, rank {r} failed:\n{text[-4000:]}"
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    for n, ps in procs.items():
        out_dir = Path(ps[0].args[-1])
        outs[n] = []
        for r in range(n):
            with np.load(out_dir / f"rank{r}.npz") as z:
                case: dict = {}
                for key in z.files:
                    name, i = key.rsplit("/", 1)
                    case.setdefault(name, {})[int(i)] = z[key]
                outs[n].append({k: tuple(v[i] for i in sorted(v)) for k, v in case.items()})
    return outs


STATS_CASES = {  # name: (frame, cs, YUV family)
    "spatial_rgb": ("gray", 1, False),
    "spatial_yuv": ("yuv", 1, True),
    "local_analyze": ("host", 2, False),
}
PIPE_CASES = {  # name: (frame, cs, tm, th_low, th_high, YUV family)
    **{f"pipe_tm{i}": ("pipe", 2, tm, 0.5, 1.0, False) for i, tm in enumerate(worker.CLOCKS)},
    "pipe_tm0_tensor": ("pipe", 2, worker.CLOCKS[0], 0.5, 1.0, False),
    "pipe_yuv": ("yuv", 1, 0.0, 0.75, 1.0, True),
    "local_pipe": ("host", 2, 3.25, 0.5, 0.9, False),
}
BATCH_CASES = {"batch_rgb": ("batch", 2, False), "local_batch": ("batch", 2, False),
               "batch_yuv": ("batch_yuv", 1, True)}


@requires_8
@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", list(STATS_CASES))
def test_ranks_spatial_analyze(ranks, n, name):
    frame, cs, yuv = STATS_CASES[name]
    want = golden_stats(X[frame], cs, yuv)
    ref = jax_case(name, n)
    for r in range(n):
        assert_same(ranks[n][r][name], ref, f"{name} rank {r} vs JAX")
        assert_same(ranks[n][r][name], want, f"{name} rank {r} vs golden")


@requires_8
@pytest.mark.parametrize("n", RANKS)
def test_ranks_saturate_only_after_the_merge(ranks, n):
    """The grey bin holds fewer than 255 pixels on every rank and more in
    all: the merged, saturated count is 255."""
    yuv = golden.rgb_to_yuv_u8(X["gray"], JaxColorspace.BT601)
    u, v = yuv[0, 0, 1], yuv[0, 0, 2]
    per_rank = [((blk[..., 1] == u) & (blk[..., 2] == v)).sum()
                for blk in np.split(yuv, n, axis=0)]
    assert max(per_rank) < 255 < sum(per_rank)
    for r in range(n):
        assert ranks[n][r]["spatial_rgb"][0][v, u] == 255


@requires_8
@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", list(PIPE_CASES))
def test_ranks_spatial_pipeline(ranks, n, name):
    """Every rank's statistics and its rows of the three overlays against
    JAX's pipeline on n devices (JAX's rows of that block) and golden."""
    frame, cs, tm, lo, hi, yuv = PIPE_CASES[name]
    f = X[frame]
    ref = jax_case(name.replace("_tensor", ""), n)
    want_ov = golden_overlays(f, cs, tm, lo, hi)
    hb = f.shape[0] // n
    for r in range(n):
        got = ranks[n][r][name]
        rows = slice(r * hb, (r + 1) * hb)
        assert_same(got[:3], ref[:3], f"{name} rank {r} stats vs JAX")
        assert_same(got[:3], golden_stats(f, cs, yuv), f"{name} rank {r} stats vs golden")
        assert_same(got[3:], tuple(p[:, rows] for p in ref[3:]), f"{name} rank {r} vs JAX")
        assert_same(tuple(_rgba(p) for p in got[3:]), tuple(o[rows] for o in want_ov),
                    f"{name} rank {r} overlays vs golden")


@requires_8
@pytest.mark.parametrize("n", RANKS)
def test_ranks_peaking_crosses_the_boundaries(ranks, n):
    """The crafted rows give focus-peaking pixels on both sides of every
    shard boundary, where a block's peaking alone (its edges clamped)
    differs from the frame's: only the exchanged rows make them right."""
    from obs_color_monitor_tpu_torch.ops.overlays import focus_peaking_planes

    f = X["pipe"]
    want = golden.focus_peaking(f, 0.05, (1.0, 0.0, 0.0, 1.0))
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0)))
    hb = H // n
    for r in range(n):
        alone = _rgba(focus_peaking_planes(planes[:, r * hb:(r + 1) * hb].contiguous(), PF,
                                           (255, 0, 0, 255)))
        edges = [i for i in (0, hb - 1) if 0 < r * hb + i < H - 1 and
                 (i == 0 and r > 0 or i == hb - 1 and r < n - 1)]
        assert edges and all((alone[i] != want[r * hb + i]).any() for i in edges), r
    got = np.concatenate([_rgba(ranks[n][r]["pipe_tm0"][5]) for r in range(n)])
    assert np.array_equal(got, want)


@requires_8
@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_ranks_batch_analyze(ranks, n, name):
    frame, cs, yuv = BATCH_CASES[name]
    frames = X[frame]
    ref = jax_case(name, n)
    k = frames.shape[0] // n
    for r in range(n):
        got = ranks[n][r][name]
        assert_same(got, tuple(o[r * k:(r + 1) * k] for o in ref), f"{name} rank {r} vs JAX")
        for b in range(k):
            assert_same(tuple(o[b] for o in got), golden_stats(frames[r * k + b], cs, yuv),
                        f"{name} rank {r} frame {b} vs golden")


@requires_8
@pytest.mark.parametrize("n", RANKS)
def test_ranks_batched_step(ranks, n):
    """``make_batched_step(mesh=)`` on each rank's shard equals JAX's
    sharded step on n devices, field by field (the rendered histogram is
    held to the unsharded port step, see tests/test_torch_batched.py)."""
    ref = dict(zip(ScopeOutputs._fields, jax_case("step", n)))
    whole = make_batched_step(worker.STEP_H, worker.STEP_W, device="cpu",
                              cs=Colorspace.BT709, scale=1)(
        torch.from_numpy(X["step"]), torch.from_numpy(X["step_tms"])).to_numpy()
    k = worker.STEP_B // n
    for r in range(n):
        got = dict(zip(ScopeOutputs._fields, ranks[n][r]["step"]))
        rows = slice(r * k, (r + 1) * k)
        for field, v in got.items():
            assert np.array_equal(v, whole[field][rows]), (r, field)
            if field != "histogram":
                assert np.array_equal(v, ref[field][rows]), (r, field)


@pytest.mark.parametrize("n", RANKS)
def test_ranks_raise_on_bad_arguments(ranks, n):
    """Indivisible H (spatial_analyze, spatial_pipeline) and B
    (batch_analyze, shard_batch), bad components, a backend that is not
    None and n_devices other than the world size: ValueError on every
    rank."""
    for r in range(n):
        (raised,) = ranks[n][r]["raised"]
        assert raised.tolist() == [1] * 7, (r, raised)


@pytest.mark.parametrize("n", RANKS)
def test_ranks_cases_ran_through_the_cached_steps(ranks, n):
    """Every case of the workers went through ``mesh._mesh_step``: one step
    per (path, static arguments) held per group, the calls that differ
    only in their frame, rows or clock (a float or a tensor) sharing it."""
    for r in range(n):
        (steps,) = ranks[n][r]["steps"]
        assert steps.tolist() == [2, 3, 3], (r, steps)


@pytest.mark.parametrize("n", RANKS)
def test_ranks_mesh_steps_are_one_program(ranks, n):
    """At n ranks each path's step dispatches the same operations from its
    second call on, reads nothing back to the host and holds its collective
    (the all-reduce, and the halo's rows in the pipeline) in every call:
    what capturing it as one CUDA graph needs."""
    for r in range(n):
        (flags,) = ranks[n][r]["one_program"]
        assert flags.tolist() == [[1, 1, 1]] * 3, (r, flags)
