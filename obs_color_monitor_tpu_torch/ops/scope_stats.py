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
    u: torch.Tensor, v: torch.Tensor, data: torch.Tensor, mask: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ((256, 256) int32 counts[v, u] over every pixel,
    (3, 256, w) int32 per-column waveform of ``data`` skipping pixels whose
    ``mask`` is 0)."""
    return vectorscope_counts_uv(u, v), waveform_counts_i32(data, mask)


def _check_plane(name: str, t: torch.Tensor, h: int, w: int) -> None:
    if t.dtype not in (torch.uint8, torch.bool) or t.shape != (h, w) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({h}, {w}) u8 plane, got "
                         f"{tuple(t.shape)} {t.dtype}")


def vs_wv_counts(
    u: torch.Tensor, v: torch.Tensor, data: torch.Tensor, mask: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorscope and waveform counts of planar u8 inputs.

    u, v: (h, w) u8; data: (3, h, w) u8 whose planes are each contiguous
    (a channel slice of a (C, h, w) tensor is fine); mask: (h, w) u8/bool or
    None (the YUV family never skips).  A CPU tensor runs the plain
    version; a CUDA tensor launches K2.
    """
    if u.device.type == "cpu":
        return vs_wv_counts_reference(u, v, data, mask)
    if u.device.type != "cuda":
        raise ValueError(f"vs_wv_counts: unsupported device {u.device}")
    h, w = u.shape
    for name, t in (("u", u), ("v", v)):
        _check_plane(name, t, h, w)
    if (
        data.dtype != torch.uint8
        or data.shape != (3, h, w)
        or data.stride()[1:] != (w, 1)
    ):
        raise ValueError(f"data must be (3, {h}, {w}) u8 with contiguous planes")
    if mask is not None:
        _check_plane("mask", mask, h, w)
    tensors = [v, data] + ([mask] if mask is not None else [])
    if any(t.device != u.device for t in tensors):
        raise ValueError("vs_wv_counts: inputs on different devices")
    vs = torch.zeros((VS_SIZE, VS_SIZE), dtype=torch.int32, device=u.device)
    wv = torch.empty((3, WV_SIZE, w), dtype=torch.int32, device=u.device)
    lib = _kernels.library()
    with torch.cuda.device(u.device):
        rc = lib.ocm_scope_stats(
            u.data_ptr(), v.data_ptr(), data.data_ptr(), data.stride(0),
            mask.data_ptr() if mask is not None else None, h, w,
            vs.data_ptr(), wv.data_ptr(), _kernels.stream_handle(u.device),
        )
    vs_wv_counts.launches += 1
    _kernels.check(rc, "scope_stats")
    return vs, wv


vs_wv_counts.launches = 0
