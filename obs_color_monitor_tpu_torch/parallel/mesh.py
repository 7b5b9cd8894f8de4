"""Multi-device scaling over ``torch.distributed``: batch data-parallel over
frames, and one frame's rows sharded with its counts merged by an
all-reduce.

Counterpart of ``obs_color_monitor_tpu/parallel/mesh.py`` (``:37-271``).
A JAX mesh is one program over many devices; here a mesh is a 1-D
``DeviceMesh`` over a process group, one process (rank) per device, and
every function below is called by every rank:

* **batch data-parallel** (``batch_analyze``, ``make_batched_step(mesh=)``):
  each rank analyzes its own slice of the batch and keeps the results, with
  no collective (per-frame results are small and stay where the frame
  lives);
* **spatial sharding** (``spatial_analyze``, ``spatial_pipeline``): each
  rank counts its block of rows into unsaturated int32 vectorscope and
  waveform counts, one ``all_reduce(SUM)`` merges them over the mesh, and
  only then are they saturated, so the result equals the unsharded one bit
  for bit (sums commute; the u8 clamp does not).  ``spatial_pipeline`` also
  computes the three overlays on the rank's rows, with a one-row halo for
  focus peaking.

On a rank's device the work runs as the unsharded path's does: kernel K1
(``ops/pipeline.frame_pass``, at scale 1: the planes and their Q12 YUV, and
the overlays for ``spatial_pipeline``) and K2 in its both-counts mode
(``ops/scope_stats.vs_wv_counts``, the TPU's ``_fused_kernel``, which JAX's
mesh reaches through ``mesh.py:104-111``); focus peaking's boundary rows
go through K3 (``ops/fused_overlays``).  A CPU mesh runs their plain
versions.  The backend follows the device: NCCL for a CUDA mesh, gloo for a
CPU mesh; a group whose backend does not serve the mesh's device raises.

A frame reaches the functions in one of two forms:

* **single-controller**: every rank passes the whole frame (or batch), as
  one JAX program is handed a global array; each rank takes its own rows
  (:func:`shard_rows`) or frames (:func:`shard_batch`);
* **host-local ingest** (``local=True``): each rank passes only its own
  block, as each host of a JAX pod uploads only its rows
  (``tests/_multihost_worker.py``).  Every rank's block has the same
  shape, as JAX's sharding requires.

Each function is a host side and a device step, as each JAX path is one
``jax.jit`` program: the host side checks the arguments and takes this
rank's block onto its device (:func:`shard_rows`, :func:`shard_batch` or
the local block), and the device step, a ``graphs.CapturedStep`` cached per
(path, process group, static arguments) as ``jax.jit`` caches per static
argument, does the rest.  On a card a call after the first is one CUDA
graph replay holding K1, K2, the count merge (the concatenation and the
NCCL all-reduce), saturation, the histogram and, for the pipeline, the
halo's point-to-point rows and K3's boundary strips; on the CPU the step
runs as it is.  The block and ``tm`` are the graph's inputs; the rank's
row offset is a constant of the capture.

A collective in a graph is matched across ranks by position, at every
replay as in the eager call: every rank must call the same functions with
the same arguments in the same order (so that each warms up, captures,
replays and evicts the same graphs alike).  A rank that skips a call
deadlocks the others.
"""

from __future__ import annotations

import os
import weakref

import torch
import torch.distributed as dist

from ..graphs import CapturedStep
from ..ops.convert import _as_device_arg, packed_view
from ..ops.fused_overlays import fused_overlays_planes
from ..ops.overlays import clock_tensor
from ..ops.pipeline import frame_pass, stats_inputs
from ..ops.scope_stats import histogram_from_waveform, vs_wv_counts
from ..ops.stats import saturate_u8

BATCH_AXIS = "batch"
SPATIAL_AXIS = "rows"

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _check_group_backend(device_type: str) -> None:
    """Raise unless the default group's backend serves ``device_type``
    (a group may carry one backend per device type, "cpu:gloo,cuda:nccl")."""
    backend = str(dist.get_backend())
    if _BACKENDS[device_type] not in backend:
        raise ValueError(f"a {device_type} mesh needs a {_BACKENDS[device_type]} process "
                         f"group, got {backend!r}")


def _local_cuda_index() -> int:
    """This rank's card: ``LOCAL_RANK`` (set by torchrun), else the rank
    modulo the cards of the host."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))


def make_mesh(n_devices: int | None = None, axis: str = BATCH_AXIS, device="cuda"):
    """A 1-D ``DeviceMesh`` named ``axis`` over the initialized process
    group, one rank per device: rank r runs on ``cuda:LOCAL_RANK`` (a CUDA
    mesh) or on the CPU.

    Unlike a JAX mesh device, a torch rank is a process: the mesh's size is
    the group's world size, and every rank calls the functions of this
    module.  ``n_devices``, when given, must equal the world size
    (``ValueError`` otherwise, with no group started).  With no group initialized, a world-size-1
    group is started in this process (NCCL on a card, gloo on the CPU), so
    that a one-card run works as the JAX call does on one chip; a
    multi-process run initializes its group first
    (``torch.distributed.init_process_group``, e.g. from torchrun's
    environment)."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device(device).type
    if device_type not in _BACKENDS:
        raise ValueError(f"make_mesh: device must be cuda or cpu, got {device!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device")
    if not dist.is_initialized():
        # refused before the group starts: a refused call leaves none behind
        if n_devices is not None and n_devices != 1:
            raise ValueError(f"make_mesh: n_devices={n_devices}, but no process group is "
                             "initialized and the one started here has world size 1 (one "
                             "rank per device)")
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(_BACKENDS[device_type], store=dist.HashStore(), rank=0,
                                world_size=1)
    _check_group_backend(device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the process group has "
                         f"world size {world} (one rank per device)")
    if device_type == "cuda":
        torch.cuda.set_device(_local_cuda_index())
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def mesh_device(mesh) -> torch.device:
    """The device this rank's share of the mesh's work runs on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", _local_cuda_index())
    return torch.device(mesh.device_type)


def _size_rank(mesh) -> tuple[int, int]:
    _check_group_backend(mesh.device_type)
    return mesh.size(), mesh.get_local_rank()


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host array or a tensor as a contiguous tensor on ``device``."""
    return _as_device_arg(x, device).to(device).contiguous()


def _slice(x, mesh, what: str) -> torch.Tensor:
    """This rank's block of ``x`` along its first axis, on the mesh's device."""
    n, r = _size_rank(mesh)
    if x.shape[0] % n:
        raise ValueError(f"{what} {x.shape[0]} not divisible by mesh size {n}")
    k = x.shape[0] // n
    return _to_device(x[r * k:(r + 1) * k], mesh_device(mesh))


def shard_batch(frames, mesh) -> torch.Tensor:
    """This rank's frames of a global (B, H, W, 4) batch (a host array or a
    tensor), on its device: frames [r * B/n, (r + 1) * B/n), the block JAX's
    ``NamedSharding(mesh, P("batch"))`` places on device r.  ``ValueError``
    unless the mesh size divides B."""
    return _slice(frames, mesh, "batch")


def shard_rows(frame, mesh) -> torch.Tensor:
    """This rank's rows of a global (H, W, 4) frame, on its device: rows
    [r * H/n, (r + 1) * H/n), JAX's ``P("rows")`` block of device r.
    ``ValueError`` unless the mesh size divides H."""
    return _slice(frame, mesh, "height")


def _local(x, mesh) -> torch.Tensor:
    """A rank's own block (host-local ingest) on its device."""
    _check_group_backend(mesh.device_type)
    return _to_device(x, mesh_device(mesh))


def _check_args(backend, components: str) -> bool:
    """Whether the waveform and histogram count the YUV family (``_family``,
    ``mesh.py:53-62``): "rgb" is the RGB planes with the alpha skip, "yuv"
    the Y/U/V planes with no skip."""
    if backend is not None:
        raise ValueError(f"backend={backend!r}: the port has no backend switch, the "
                         "device picks the route (pass None)")
    if components not in ("rgb", "yuv"):
        raise ValueError(f"components must be 'rgb' or 'yuv', got {components!r}")
    return components == "yuv"


def _rgba(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.uint8 or x.ndim not in (3, 4) or x.shape[-1] != 4:
        raise ValueError(f"frames must be (..., H, W, 4) u8, got {tuple(x.shape)} {x.dtype}")
    return x


def _results(vs: torch.Tensor, wv: torch.Tensor):
    """(vs u8, hist u32, waveform u8) of merged int32 counts: saturation
    last, the histogram the column sum of the waveform (``mesh.py:142-148``),
    summed in int32 and cast to uint32 at the end, as ``ScopeOutputs``
    does."""
    return saturate_u8(vs), histogram_from_waveform(wv).to(torch.uint32), saturate_u8(wv)


def _all_reduce_counts(vs: torch.Tensor, wv: torch.Tensor, group):
    """The mesh-wide sum of the int32 counts, by one all-reduce of both."""
    flat = torch.cat([vs.reshape(-1), wv.reshape(-1)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return flat[:vs.numel()].view(vs.shape), flat[vs.numel():].view(wv.shape)


def _halo_rows(planes: torch.Tensor, group, n: int, r: int):
    """(above, below): the last row of rank r - 1 and the first row of rank
    r + 1, each (4, 1, W) u8, or None at the mesh's edge.  Each rank sends
    its last row down and its first row up in one batch of point-to-point
    operations; a rank with no neighbour posts nothing (at n = 1 nothing at
    all, so NCCL never sends to itself)."""
    ops, above, below = [], None, None
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        above = torch.empty_like(planes[:, :1])
        ops += [dist.P2POp(dist.isend, planes[:, :1].contiguous(), peer, group),
                dist.P2POp(dist.irecv, above, peer, group)]
    if r < n - 1:
        peer = dist.get_global_rank(group, r + 1)
        below = torch.empty_like(planes[:, -1:])
        ops += [dist.P2POp(dist.isend, planes[:, -1:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, below, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return above, below


def peaking_boundary_rows(fp: torch.Tensor, planes: torch.Tensor, above, below,
                          peak_th: int, peak_rgba) -> torch.Tensor:
    """Correct focus peaking's first and last rows of a row block for its
    neighbours' rows, in place, and return ``fp``.

    ``fp`` is the peaking of the (4, hb, W) block ``planes`` alone, whose
    edge rows were clamped as image edges; ``above`` / ``below`` are the
    neighbouring (4, 1, W) rows, None at the mesh's edge, where the clamp is
    right (a substituted copy of the block's own row gives the same zero
    difference, ``mesh.py:235-253``).  Each corrected row is row 1 of a
    3-row strip (its neighbour, itself, the next row in), whose peaking K3
    computes exactly.  K3's clock (unused: the zebra is off) is filled on
    the device, so the strips capture into a graph."""
    hb = planes.shape[1]
    up = planes[:, :1] if above is None else above
    down = planes[:, -1:] if below is None else below
    strips = []  # (row of fp, the 3-row strip around it)
    if hb == 1:
        if above is not None or below is not None:
            strips.append((0, [up, planes, down]))
    else:
        if above is not None:
            strips.append((0, [up, planes[:, :2]]))
        if below is not None:
            strips.append((hb - 1, [planes[:, -2:], down]))
    for row, parts in strips:
        strip = torch.cat(parts, dim=1)
        _, _, peaks = fused_overlays_planes(
            strip, 0.0, th_low=0.0, th_high=0.0, zb_cs=2, fc_cs=2, peak_th=int(peak_th),
            peak_rgba=peak_rgba, outputs=(False, False, True))
        fp[:, row] = peaks[:, 1]
    return fp


# --------------------------------------------------------------------------
# the device steps, one captured step per (path, group, static arguments)
# --------------------------------------------------------------------------

# {process group: {(path, static arguments): its step}}.  Weak: a step holds
# its group weakly, so the steps of a destroyed group go with it.
_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _overlay_args(cs: int, th_low: float = 0.75, th_high: float = 1.0, zb_cs=None, fc_cs=None,
                  peak_th: int = 3062, peak_rgba=(255, 0, 0, 255)) -> dict:
    """``spatial_pipeline``'s overlay arguments as K1 takes them, with
    ``zb_cs`` / ``fc_cs`` defaulting to ``cs``."""
    return dict(th_low=float(th_low), th_high=float(th_high),
                zb_cs=int(cs if zb_cs is None else zb_cs),
                fc_cs=int(cs if fc_cs is None else fc_cs), peak_th=int(peak_th),
                peak_rgba=tuple(int(c) for c in peak_rgba))


def _device_step(path: str, group_ref, n: int, r: int, cs: int, yuv_data: bool, ov: dict):
    """The uncaptured device step of ``path`` on rank ``r`` of ``n``: the
    block (and for the pipeline the clock) in, the path's outputs out."""

    def counts(x, *clock, overlays=False):
        ds, yuv, *ovs = frame_pass(packed_view(x), *clock, packed=True, cs=cs, scale=1,
                                   with_overlays=overlays, **ov)
        return ds, vs_wv_counts(*stats_inputs(ds, yuv, yuv_data)), ovs

    def batch_analyze(x):
        return _results(*counts(x)[1])

    def spatial_analyze(x):
        return _results(*_all_reduce_counts(*counts(x)[1], group_ref()))

    def spatial_pipeline(x, tm):
        # the zebra's global row: tm + float32(r * H/n), one float32 addition
        # on the device (mesh.py:228-232); the offset is a capture constant
        offset = torch.full((), float(r * x.shape[0]), dtype=torch.float32, device=x.device)
        clock = clock_tensor(tm, x.device) + offset
        ds, (vs, wv), (zb, fc, fp) = counts(x, clock, overlays=True)
        group = group_ref()
        stats = _results(*_all_reduce_counts(vs, wv, group))
        above, below = _halo_rows(ds, group, n, r)
        fp = peaking_boundary_rows(fp, ds, above, below, ov["peak_th"], ov["peak_rgba"])
        return (*stats, zb, fc, fp)

    return {"batch_analyze": batch_analyze, "spatial_analyze": spatial_analyze,
            "spatial_pipeline": spatial_pipeline}[path]


def _mesh_step(path: str, mesh, *, cs: int, components: str = "rgb", **overlays) -> CapturedStep:
    """The device step of ``path`` ("batch_analyze", "spatial_analyze" or
    "spatial_pipeline") for this rank of ``mesh`` and these static
    arguments: ``cs``, ``components`` and, for ``spatial_pipeline``, the
    overlay arguments (``th_low``, ``th_high``, ``zb_cs``, ``fc_cs``,
    ``peak_th``, ``peak_rgba``; defaults as :func:`spatial_pipeline`'s).  Made at the first call with these
    arguments and cached per process group; ``.eager`` is its uncaptured
    body, ``step(block)`` or ``step(block, tm)``."""
    yuv_data = _check_args(None, components)
    ov = _overlay_args(int(cs), **overlays) if path == "spatial_pipeline" else {}
    group = mesh.get_group()
    steps = _STEPS.setdefault(group, {})
    key = (path, int(cs), yuv_data, tuple(sorted(ov.items())))
    step = steps.get(key)
    if step is None:
        body = _device_step(path, weakref.ref(group), mesh.size(), mesh.get_local_rank(),
                            int(cs), yuv_data, ov)
        step = steps[key] = CapturedStep(body, mesh_device(mesh))
    return step


# --------------------------------------------------------------------------
# the public functions: the host side, then the device step
# --------------------------------------------------------------------------


def batch_analyze(frames, mesh, cs: int, backend: str | None = None, components: str = "rgb",
                  *, local: bool = False):
    """Batch data-parallel statistics: this rank's (vs (b, 256, 256) u8,
    hist (b, 3, 256) u32, waveform (b, 3, 256, W) u8), b = B / n, on its
    device, with no collective.

    ``frames`` is the global (B, H, W, 4) u8 batch, of which this rank
    takes :func:`shard_batch`'s slice, or with ``local`` this rank's own
    (b, H, W, 4) frames.  K1 runs once for the local batch (scale 1, no
    overlays), then K2 once (both counts), then saturation, as one step.
    ``components`` picks the waveform and histogram family; ``backend``
    must be None."""
    _check_args(backend, components)
    x = _rgba(_local(frames, mesh) if local else shard_batch(frames, mesh))
    if x.ndim != 4:
        raise ValueError(f"frames must be (B, H, W, 4), got {tuple(x.shape)}")
    return _mesh_step("batch_analyze", mesh, cs=cs, components=components)(x)


def _row_block(frame, mesh, local: bool) -> torch.Tensor:
    x = _rgba(_local(frame, mesh) if local else shard_rows(frame, mesh))
    if x.ndim != 3:
        raise ValueError(f"frame must be (H, W, 4), got {tuple(x.shape)}")
    return x


def spatial_analyze(frame, mesh, cs: int, backend: str | None = None, components: str = "rgb",
                    *, local: bool = False):
    """One frame, rows sharded over the mesh, partial counts merged:
    (vs u8 (256, 256), hist u32 (3, 256), waveform u8 (3, 256, W)), the
    same on every rank.

    ``frame`` is the whole (H, W, 4) u8 frame (this rank counts
    :func:`shard_rows`'s block; ``ValueError`` unless the mesh size divides
    H), or with ``local`` this rank's own block.  K1 and K2 count the block
    into int32; one ``all_reduce(SUM)`` over the mesh's group merges the
    vectorscope and waveform counts, then they saturate.  The histogram is
    the column sum of the merged waveform."""
    _check_args(backend, components)
    x = _row_block(frame, mesh, local)
    return _mesh_step("spatial_analyze", mesh, cs=cs, components=components)(x)


def spatial_pipeline(
    frame,
    mesh,
    cs: int,
    tm: float | torch.Tensor = 0.0,
    *,
    components: str = "rgb",
    th_low: float = 0.75,
    th_high: float = 1.0,
    zb_cs: int | None = None,
    fc_cs: int | None = None,
    peak_th: int = 3062,
    peak_rgba: tuple[int, int, int, int] = (255, 0, 0, 255),
    backend: str | None = None,
    local: bool = False,
):
    """The full pass, rows sharded: the merged statistics and the three
    overlays of this rank's rows.

    Returns (vs u8 (256, 256), hist u32 (3, 256), waveform u8 (3, 256, W),
    zebra, falsecolor, focuspeaking): the statistics as
    :func:`spatial_analyze` gives them, the same on every rank, and the
    overlays of this rank's rows only, (4, H/n, W) u8 each, on its device
    (JAX returns the overlays sharded on their row axis; a rank holds its
    shard).  ``frame`` and ``local`` as in :func:`spatial_analyze`.

    * zebra: the stripe phase is ``floor(x + y + 1 + tm)`` with y global.
      The row offset r * H/n is folded into the clock as one float32
      addition on the device, ``tm + float32(r * H/n)`` (``mesh.py:228-232``),
      and K1 computes the block's zebra with that clock, so the phase
      rounds as JAX's;
    * false colour is pointwise;
    * focus peaking: K1 computes it on the block; the block's first and
      last rows are then corrected with the neighbours' boundary rows,
      exchanged point to point (:func:`peaking_boundary_rows`).

    ``tm`` is a float or a 0-d float32 tensor on the rank's device;
    ``zb_cs`` / ``fc_cs`` default to ``cs``; ``backend`` must be None."""
    _check_args(backend, components)
    x = _row_block(frame, mesh, local)
    step = _mesh_step("spatial_pipeline", mesh, cs=cs, components=components, th_low=th_low,
                      th_high=th_high, zb_cs=zb_cs, fc_cs=fc_cs, peak_th=peak_th,
                      peak_rgba=peak_rgba)
    return step(x, tm)
