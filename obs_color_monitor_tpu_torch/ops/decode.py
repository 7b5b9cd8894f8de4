"""NV12 / P010 decode: the wrappers of kernels K4 and K5 and their plain
versions.

Counterpart of ``obs_color_monitor_tpu/ops/pallas_convert.py``
(``nv12_decode_pallas`` ``:134``, kernel ``_decode_band`` ``:60``;
``nv12_16_decode_pallas`` ``:169``, kernel ``_decode16_band`` ``:88``).  The
TPU kernels decode 64-row bands into quarter- or half-width planes that XLA
interleaves afterwards; the CUDA kernels (``ops/csrc/nv12_decode.cu``)
write the (H, W) packed frame directly.  A batch of frames, a leading B on
both planes, decodes in one launch (the grid's z axis, as ``vmap`` adds a
grid axis to the ``pallas_call``).  The plain versions are
``convert.nv12_packed_reference`` and ``convert.nv12_16_packed_reference``.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .convert import _NV12_COEF, check_nv12, nv12_16_packed_reference, nv12_packed_reference


def _launch(entry: str, y: torch.Tensor, uv: torch.Tensor, cs: int, *shift: int) -> torch.Tensor:
    """Launch ``entry`` on the planes; ``shift`` is K5's only."""
    if uv.device != y.device:
        raise ValueError(f"{entry}: y on {y.device}, uv on {uv.device}")
    if not (y.is_contiguous() and uv.is_contiguous()):
        raise ValueError(f"{entry}: the planes must be contiguous")
    h, w = y.shape[-2:]
    batch = y.shape[0] if y.ndim == 3 else 1
    out = torch.empty(tuple(y.shape), dtype=torch.int32, device=y.device)
    lib = _kernels.library()
    with torch.cuda.device(y.device):
        rc = getattr(lib, entry)(
            y.data_ptr(), uv.data_ptr(), batch, h, w, *shift, *_NV12_COEF[int(cs)],
            out.data_ptr(), _kernels.stream_handle(y.device),
        )
    _kernels.check(rc, entry)
    return out


def nv12_decode(y: torch.Tensor, uv: torch.Tensor, cs: int = 2) -> torch.Tensor:
    """K4: NV12 y (H, W) u8 + uv (H/2, W) u8 -> packed (H, W) int32 RGBA,
    or a batch, (B, H, W) + (B, H/2, W) -> (B, H, W), in one launch.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    if y.device.type == "cpu":
        return nv12_packed_reference(y, uv, cs)
    if y.device.type != "cuda":
        raise ValueError(f"nv12_decode: unsupported device {y.device}")
    check_nv12(y, uv)
    out = _launch("ocm_nv12_decode", y, uv, cs)
    nv12_decode.launches += 1
    return out


nv12_decode.launches = 0


def nv12_16_decode(
    y16: torch.Tensor, uv16: torch.Tensor, cs: int = 2, shift: int = 2
) -> torch.Tensor:
    """K5: P010-family y (H, W) u16 + uv (H/2, W) u16 -> packed (H, W)
    int32 RGBA, each sample round-shifted ``min((v + half) >> shift, 255)``
    (``shift`` in 1..8) before the K4 decode; a batch as K4's.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel."""
    if y16.device.type == "cpu":
        return nv12_16_packed_reference(y16, uv16, cs, shift)
    if y16.device.type != "cuda":
        raise ValueError(f"nv12_16_decode: unsupported device {y16.device}")
    check_nv12(y16, uv16, shift)
    out = _launch("ocm_nv12_16_decode", y16, uv16, cs, int(shift))
    nv12_16_decode.launches += 1
    return out


nv12_16_decode.launches = 0
