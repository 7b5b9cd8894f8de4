"""Vectorscope + waveform counting: the wrapper of kernel K2 and its plain
version.

Counterpart of ``obs_color_monitor_tpu/ops/pallas_stats.py``:
``vs_swar_from_tiles`` (``:356``, kernel ``_vs_swar_tiles_kernel``
``:315``) and ``histogram_from_waveform`` (``:242``).  The TPU kernel counts
from the frame pipeline's (S, NB, OH, 128) tiles and leaves padding and
alpha corrections to its caller; this one reads planar (h, w) planes,
masks its own ragged edge and skips masked pixels itself, so its outputs
are final.  The CUDA source is ``ops/csrc/scope_stats.cu``.
"""

from __future__ import annotations

import torch

from .. import _kernels
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
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Plain version of K2: ((256, 256) int32 counts[v, u] over every pixel,
    (3, 256, w) int32 per-column waveform of ``data`` skipping pixels whose
    ``mask`` is 0); an output not needed is None."""
    vs = vectorscope_counts_uv(u, v) if need_vs else None
    wv = waveform_counts_i32(data, mask) if need_wv else None
    return vs, wv


def _check_plane(name: str, t: torch.Tensor, h: int, w: int) -> None:
    if t.dtype not in (torch.uint8, torch.bool) or t.shape != (h, w) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({h}, {w}) u8 plane, got "
                         f"{tuple(t.shape)} {t.dtype}")


def vs_wv_counts(
    u: torch.Tensor | None,
    v: torch.Tensor | None,
    data: torch.Tensor | None,
    mask: torch.Tensor | None,
    *,
    need_vs: bool = True,
    need_wv: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Vectorscope and waveform counts of planar u8 inputs.

    u, v: (h, w) u8 (read only with ``need_vs``); data: (3, h, w) u8 whose
    planes are each contiguous (a channel slice of a (C, h, w) tensor is
    fine) and mask: (h, w) u8/bool or None (the YUV family never skips),
    both read only with ``need_wv``.  A cropped plane must be made
    contiguous first.  With one of the flags off, only the other kernel
    launches and its output is None: the counterparts of the TPU's
    standalone vectorscope (K7) and waveform (K8) kernels; with both, of its
    fused kernel (K6) as well as K2.  A CPU tensor runs the plain version; a
    CUDA tensor launches K2.
    """
    if not (need_vs or need_wv):
        raise ValueError("vs_wv_counts: nothing to count")
    ref = u if need_vs else data
    if ref.device.type == "cpu":
        return vs_wv_counts_reference(u, v, data, mask, need_vs=need_vs, need_wv=need_wv)
    if ref.device.type != "cuda":
        raise ValueError(f"vs_wv_counts: unsupported device {ref.device}")
    h, w = ref.shape[-2:]
    tensors = []
    if need_vs:
        for name, t in (("u", u), ("v", v)):
            _check_plane(name, t, h, w)
        tensors += [u, v]
    if need_wv:
        if (
            data.dtype != torch.uint8
            or data.shape != (3, h, w)
            or data.stride()[1:] != (w, 1)
        ):
            raise ValueError(f"data must be (3, {h}, {w}) u8 with contiguous planes")
        tensors.append(data)
        if mask is not None:
            _check_plane("mask", mask, h, w)
            tensors.append(mask)
    if any(t.device != ref.device for t in tensors):
        raise ValueError("vs_wv_counts: inputs on different devices")
    dev = ref.device
    vs = torch.zeros((VS_SIZE, VS_SIZE), dtype=torch.int32, device=dev) if need_vs else None
    wv = torch.empty((3, WV_SIZE, w), dtype=torch.int32, device=dev) if need_wv else None
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.ocm_scope_stats(
            ptr(u) if need_vs else None, ptr(v) if need_vs else None,
            ptr(data) if need_wv else None, data.stride(0) if need_wv else 0,
            ptr(mask) if need_wv else None, h, w, ptr(vs), ptr(wv),
            int(need_vs), int(need_wv), _kernels.stream_handle(dev),
        )
    vs_wv_counts.launches += 1
    if not need_wv:
        vs_wv_counts.launches_vs_only += 1
    elif not need_vs:
        vs_wv_counts.launches_wv_only += 1
    _kernels.check(rc, "scope_stats")
    return vs, wv


# every launch; of which with the vectorscope alone / the waveform alone
vs_wv_counts.launches = 0
vs_wv_counts.launches_vs_only = 0
vs_wv_counts.launches_wv_only = 0
