"""Vectorscope + waveform counting: the wrapper of kernel K2 and its plain
version.

Counterpart of ``obs_color_monitor_tpu/ops/pallas_stats.py``:
``vs_swar_from_tiles`` (``:356``, kernel ``_vs_swar_tiles_kernel``
``:315``) and ``histogram_from_waveform`` (``:242``).  The TPU kernel counts
from the frame pipeline's (S, NB, OH, 128) tiles and leaves padding and
alpha corrections to its caller; this one reads planar (h, w) planes,
masks its own ragged edge and skips masked pixels itself, so its outputs
are final.  A batch of frames (a leading B on every input) counts in one
launch of each grid, with per-frame outputs, as ``vmap`` adds a grid axis
to the ``pallas_call``.  The CUDA source is ``ops/csrc/scope_stats.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from .convert import clamp_rect, rect_mask
from .stats import VS_SIZE, WV_SIZE, vectorscope_counts_uv, waveform_counts_i32


def histogram_from_waveform(wv_i32: torch.Tensor) -> torch.Tensor:
    """(C, 256, W) -> (C, 256) int32 column sum: the histogram has the
    waveform's counting semantics (``pallas_stats.histogram_from_waveform``;
    glue there too, not a kernel)."""
    return wv_i32.sum(dim=-1, dtype=torch.int32)


def vs_wv_counts_reference(
    u: torch.Tensor | None,
    v: torch.Tensor | None,
    data: torch.Tensor | None,
    mask: torch.Tensor | None,
    *,
    need_vs: bool = True,
    need_wv: bool = True,
    rect: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Plain version of K2: ((256, 256) int32 counts[v, u] over every pixel,
    (3, 256, w) int32 per-column waveform of ``data`` skipping pixels whose
    ``mask`` is 0); an output not needed is None.  With a dynamic ``rect``
    only the pixels inside it count, masked by the clamped rect.  A batch
    runs frame by frame, each output gaining a leading B."""
    if _batched(u, data, need_vs):
        outs = [vs_wv_counts_reference(
            None if u is None else u[b], None if v is None else v[b],
            None if data is None else data[b], None if mask is None else mask[b],
            need_vs=need_vs, need_wv=need_wv, rect=rect)
            for b in range((u if need_vs else data).shape[0])]
        return tuple(None if o[0] is None else torch.stack(o) for o in zip(*outs))
    ref = u if need_vs else data
    inr = None
    if rect is not None:
        h, w = ref.shape[-2], ref.shape[-1]
        inr = rect_mask(clamp_rect(rect, w, h, ref.device), h, w)
        if need_wv:
            mask = inr if mask is None else (mask != 0) & inr
    vs = vectorscope_counts_uv(u, v, inr) if need_vs else None
    wv = waveform_counts_i32(data, mask) if need_wv else None
    return vs, wv


# K2's launch geometry, as scope_stats.cu lays it out.  The counters are
# 16 bits wide, so no block may add more than FIELD_MAX to one of them.
FIELD_MAX = 65535
VS_CLUSTER = 8  # vectorscope blocks per cluster, fixed in scope_stats.cu
# vectorscope blocks aimed at: one 160 KB block per SM, and 14 clusters of
# 8 are as many as an H100 holds at once; beside the waveform, which
# overlaps it (PDL), fewer, leaving that grid SMs
VS_BLOCKS_ALONE = 112
VS_BLOCKS_BESIDE_WV = 64
VS_TILE = 8192  # pixels per shared-memory stage, the least a block takes
VS_MAX_BLOCK_PIXELS = FIELD_MAX // 16 * 16  # 65520: a run is whole 16-byte words
# waveform blocks per 32-column strip, splitting its rows (the two sizes
# scope_stats.cu is compiled for)
WV_CLUSTER_ALONE = 4
WV_CLUSTER_BESIDE_VS = 2
WV_STRIP = 32


class StatsPlan(ctypes.Structure):
    """How K2 runs on one plane shape (mirror of ``StatsPlan`` in
    ``scope_stats.cu``): the vectorscope's clusters of VS_CLUSTER blocks,
    each counting a run of ``vs_per_block`` pixels; the waveform's strips of
    32 columns, each split into ``wv_cluster`` runs of ``wv_rows`` rows; and
    whether each count takes the 16-byte (cp.async) load form."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "vs_clusters", "vs_per_block", "vs_vec", "wv_strips", "wv_cluster", "wv_rows", "wv_vec")]

    def as_tuple(self) -> tuple:
        return tuple(getattr(self, name) for name, _ in self._fields_)


@functools.lru_cache(maxsize=64)
def stats_plan(h: int, w: int, *, vs_aligned: bool = True, wv_aligned: bool = True,
               need_vs: bool = True, need_wv: bool = True) -> StatsPlan:
    """K2's grids and forms for (h, w) planes: pure, and a function of the
    shape, the counts asked for and the planes' alignment only, never of a
    rect.  ``vs_aligned``: u and v start on 16-byte boundaries;
    ``wv_aligned``: the data planes and the mask do and so does the plane
    stride (the rows also need w % 16 == 0).  Every pixel falls in exactly
    one vectorscope run and one waveform (strip, row run), and no run can
    put more than FIELD_MAX in a field."""
    if h < 0 or w < 0:
        raise ValueError(f"stats_plan: bad shape {(h, w)}")
    both = need_vs and need_wv
    vs_blocks = VS_BLOCKS_BESIDE_WV if both else VS_BLOCKS_ALONE
    wv_cluster = WV_CLUSTER_BESIDE_VS if both else WV_CLUSTER_ALONE
    n = h * w
    per = max(-(-n // vs_blocks), VS_TILE)
    per = min(-(-per // 16) * 16, VS_MAX_BLOCK_PIXELS)
    clusters = max(1, -(-(-(-n // per)) // VS_CLUSTER))
    rows = max(1, -(-h // wv_cluster))
    if rows > FIELD_MAX:
        raise ValueError(f"stats_plan: {h} rows is more than {wv_cluster * FIELD_MAX}")
    return StatsPlan(clusters, per, int(vs_aligned), -(-w // WV_STRIP), wv_cluster, rows,
                     int(wv_aligned and w % 16 == 0))


def _batched(u, data, need_vs: bool) -> bool:
    """Whether K2's inputs carry a leading batch axis."""
    return u.ndim == 3 if need_vs else data.ndim == 4


def _aligned(*ts) -> bool:
    """The tensors' bases, and in a batch each frame's, are 16-byte
    aligned (a None passes)."""
    return all(t is None or (t.data_ptr() % 16 == 0 and (t.ndim < 3 or t.stride(0) % 16 == 0))
               for t in ts)


def _frame_stride(t) -> int:
    """Bytes from one frame of a batched u8 tensor to the next (0: none)."""
    return 0 if t is None else t.stride(0)


def _check_plane(name: str, t: torch.Tensor, lead: tuple, h: int, w: int) -> None:
    if (t.dtype not in (torch.uint8, torch.bool) or tuple(t.shape) != (*lead, h, w)
            or t.stride()[-2:] != (w, 1)):
        raise ValueError(f"{name} must be {(*lead, h, w)} u8 with contiguous planes, got "
                         f"{tuple(t.shape)} {t.dtype}")


def check_stats_inputs(u, v, data, mask, *, need_vs: bool, need_wv: bool, rect) -> tuple[int, int]:
    """K2's argument checks (what the kernels take): raise ValueError on
    anything else; return the planes' (h, w).  Each plane (of each frame of
    a batch) must be contiguous; frames may lie at any stride."""
    ref = u if need_vs else data
    h, w = ref.shape[-2:]
    lead = tuple(ref.shape[:1]) if _batched(u, data, need_vs) else ()
    tensors = []
    if need_vs:
        for name, t in (("u", u), ("v", v)):
            _check_plane(name, t, lead, h, w)
        tensors += [u, v]
    if need_wv:
        if (
            data.dtype != torch.uint8
            or tuple(data.shape) != (*lead, 3, h, w)
            or data.stride()[-2:] != (w, 1)
        ):
            raise ValueError(f"data must be {(*lead, 3, h, w)} u8 with contiguous planes")
        tensors.append(data)
        if mask is not None:
            _check_plane("mask", mask, lead, h, w)
            tensors.append(mask)
    if rect is not None:
        if rect.dtype != torch.int32 or rect.shape != (4,) or not rect.is_contiguous():
            raise ValueError(f"rect must be a contiguous (4,) int32 tensor, got "
                             f"{tuple(rect.shape)} {rect.dtype}")
        if h * w >= 1 << 31:
            raise ValueError("vs_wv_counts: a rect needs fewer than 2**31 pixels")
        tensors.append(rect)
    if any(t.device != ref.device for t in tensors):
        raise ValueError("vs_wv_counts: inputs on different devices")
    return h, w


def vs_wv_counts(
    u: torch.Tensor | None,
    v: torch.Tensor | None,
    data: torch.Tensor | None,
    mask: torch.Tensor | None,
    *,
    need_vs: bool = True,
    need_wv: bool = True,
    rect: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Vectorscope and waveform counts of planar u8 inputs.

    u, v: (h, w) u8 (read only with ``need_vs``); data: (3, h, w) u8 whose
    planes are each contiguous (a channel slice of a (C, h, w) tensor is
    fine) and mask: (h, w) u8/bool or None (the YUV family never skips),
    both read only with ``need_wv``.  A cropped plane must be made
    contiguous first.  With one of the flags off, only the other kernel
    launches and its output is None: the counterparts of the TPU's
    standalone vectorscope (K7) and waveform (K8) kernels; with both, of its
    fused kernel (K6) as well as K2.

    ``rect`` is a dynamic ROI (x0, y0, x1, y1), a (4,) int32 tensor on the
    planes' device, or None for the whole plane: the kernels read it from
    device memory and clamp it (:func:`convert.clamp_rect`), the vectorscope
    counts only in-rect pixels, and the waveform keeps its (3, 256, w)
    shape with the columns outside the rect zero.  The launches' shapes
    depend on (h, w) alone, never on the rect.

    A batch, a leading B on every input ((B, h, w) u and v, (B, 3, h, w)
    data, (B, h, w) mask; each frame's planes contiguous, the frames at any
    stride), counts in one call with (B, 256, 256) and (B, 3, 256, w)
    outputs; one rect serves every frame.  A CPU tensor runs the plain
    version; a CUDA tensor launches K2.
    """
    if not (need_vs or need_wv):
        raise ValueError("vs_wv_counts: nothing to count")
    ref = u if need_vs else data
    if ref.device.type == "cpu":
        return vs_wv_counts_reference(u, v, data, mask, need_vs=need_vs, need_wv=need_wv,
                                      rect=rect)
    if ref.device.type != "cuda":
        raise ValueError(f"vs_wv_counts: unsupported device {ref.device}")
    h, w = check_stats_inputs(u, v, data, mask, need_vs=need_vs, need_wv=need_wv, rect=rect)
    dev = ref.device
    batched = _batched(u, data, need_vs)
    lead = tuple(ref.shape[:1]) if batched else ()
    plane_stride = data.stride(-3) if need_wv else 0
    plan = stats_plan(
        h, w, vs_aligned=bool(need_vs and _aligned(u, v)),
        wv_aligned=bool(need_wv and _aligned(data, mask) and plane_stride % 16 == 0),
        need_vs=need_vs, need_wv=need_wv)
    # both outputs are written in full by the kernels; an empty plane
    # launches nothing and its vectorscope is zero
    alloc = torch.empty if h * w else torch.zeros
    vs = alloc((*lead, VS_SIZE, VS_SIZE), dtype=torch.int32, device=dev) if need_vs else None
    wv = alloc((*lead, 3, WV_SIZE, w), dtype=torch.int32, device=dev) if need_wv else None
    # the clusters' vectorscope partials, per frame; a single cluster writes
    # vs itself
    partial = vs
    if need_vs and plan.vs_clusters > 1:
        partial = torch.empty((*lead, plan.vs_clusters, VS_SIZE * VS_SIZE), dtype=torch.int32,
                              device=dev)
    strides = (0, 0, 0, 0)
    if batched:
        strides = tuple(_frame_stride(t) for t in (
            u if need_vs else None, v if need_vs else None, data if need_wv else None,
            mask if need_wv else None))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.ocm_scope_stats(
            ctypes.addressof(plan),
            ptr(u) if need_vs else None, ptr(v) if need_vs else None,
            ptr(data) if need_wv else None, plane_stride,
            ptr(mask) if need_wv else None, ptr(rect), h, w, ptr(vs), ptr(partial), ptr(wv),
            int(need_vs), int(need_wv), lead[0] if batched else 1, *strides,
            _kernels.stream_handle(dev),
        )
    vs_wv_counts.launches += 1
    if (plan.vs_vec or not need_vs) and (plan.wv_vec or not need_wv):
        vs_wv_counts.launches_vec += 1
    if rect is not None:
        vs_wv_counts.launches_rect += 1
    if not need_wv:
        vs_wv_counts.launches_vs_only += 1
    elif not need_vs:
        vs_wv_counts.launches_wv_only += 1
    _kernels.check(rc, "scope_stats")
    return vs, wv


# every call; of which with the vectorscope alone / the waveform alone /
# a dynamic rect / every count in the 16-byte load form
vs_wv_counts.launches = 0
vs_wv_counts.launches_vec = 0
vs_wv_counts.launches_vs_only = 0
vs_wv_counts.launches_wv_only = 0
vs_wv_counts.launches_rect = 0
