"""Scope statistics on planar tensors: vectorscope, waveform, histogram.

Counterpart of ``obs_color_monitor_tpu/ops/stats.py``.  The JAX module
counts with one-hot matmuls because a TPU has no fast scatter; these plain
versions count with ``torch.bincount``.  Counts are exact int32/int64 and
saturation (u8 min-255) comes after summation, so partial counts merge
exactly.  The hand-written kernel for the vectorscope and waveform is
``ops/scope_stats.py``.

Inputs are PLANAR: value planes (3, H, W) u8 and a mask (H, W), where a
pixel with mask 0 is skipped (alpha 0 in the RGB family).  The public
functions take a tensor or a host array-like, which goes to the default
device (``convert._as_device_arg``); a second array goes to the first's
device.
"""

from __future__ import annotations

import torch

from .convert import _as_device_arg

VS_SIZE = 256
WV_SIZE = 256
HI_SIZE = 256


def vectorscope_counts_uv(
    u: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """(H, W) U and V planes -> (256, 256) int32 counts[v, u]; every pixel
    counts (no alpha skip), or only where ``mask`` is set (a dynamic rect:
    the others go to a spare bin that is dropped)."""
    n = VS_SIZE * VS_SIZE
    idx = v.reshape(-1).to(torch.int64) * VS_SIZE + u.reshape(-1).to(torch.int64)
    if mask is not None:
        idx = torch.where(mask.reshape(-1), idx, n)
    counts = torch.bincount(idx, minlength=n + 1)[:n]
    return counts.view(VS_SIZE, VS_SIZE).to(torch.int32)


def vectorscope_counts_i32(yuv_planes: torch.Tensor) -> torch.Tensor:
    """Unsaturated int32 vectorscope of (3, H, W) Y, U, V planes
    (``stats.vectorscope_counts_i32``)."""
    yuv_planes = _as_device_arg(yuv_planes)
    return vectorscope_counts_uv(yuv_planes[1], yuv_planes[2])


def waveform_counts_i32(planes: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """(3, H, W) u8 planes -> (3, 256, W) int32 per-column counts, skipping
    pixels where ``mask`` is 0 (``stats.waveform_counts_i32``).

    Skipped pixels go to one spare bin past the end that is dropped, so the
    count needs no data-dependent indexing (no device sync on CUDA)."""
    planes = _as_device_arg(planes)
    if mask is not None:
        mask = _as_device_arg(mask, planes.device)
    h, w = planes.shape[-2], planes.shape[-1]
    nbins = WV_SIZE * w
    col = torch.arange(w, device=planes.device, dtype=torch.int64)
    out = []
    for c in range(planes.shape[0]):
        idx = planes[c].to(torch.int64) * w + col
        if mask is not None:
            idx = torch.where(mask != 0, idx, nbins)
        counts = torch.bincount(idx.reshape(-1), minlength=nbins + 1)[:nbins]
        out.append(counts.view(WV_SIZE, w).to(torch.int32))
    return torch.stack(out)


def vectorscope_counts(yuv_planes: torch.Tensor) -> torch.Tensor:
    """(3, H, W) Y, U, V planes -> (256, 256) u8 saturating counts[v, u],
    every pixel counted (``stats.vectorscope_counts``): K2's vectorscope
    alone (K7's mode) on a card, its plain version on the CPU."""
    from .scope_stats import vs_wv_counts

    yuv_planes = _as_device_arg(yuv_planes)
    u, v = yuv_planes[1].contiguous(), yuv_planes[2].contiguous()
    return saturate_u8(vs_wv_counts(u, v, None, None, need_wv=False)[0])


def waveform_counts(planes: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """(3, H, W) u8 planes -> (3, 256, W) u8 saturating per-column counts,
    pixels whose ``mask`` is 0 skipped (``stats.waveform_counts``): K2's
    waveform alone (K8's mode) on a card, its plain version on the CPU."""
    from .scope_stats import vs_wv_counts

    planes = _as_device_arg(planes)
    if mask is not None:
        mask = _as_device_arg(mask, planes.device).contiguous()
    return saturate_u8(vs_wv_counts(None, None, planes.contiguous(), mask, need_vs=False)[1])


def histogram_counts(planes: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """(3, H, W) u8 planes -> (3, 256) int32 counts, mask-0 pixels skipped.
    The JAX function returns uint32 (``stats.histogram_counts``); torch's
    uint32 lacks arithmetic, so the port keeps int32 until the API edge."""
    planes = _as_device_arg(planes)
    if mask is not None:
        mask = _as_device_arg(mask, planes.device)
    out = []
    for c in range(planes.shape[0]):
        idx = planes[c].reshape(-1).to(torch.int64)
        if mask is not None:
            idx = torch.where(mask.reshape(-1) != 0, idx, HI_SIZE)
        out.append(torch.bincount(idx, minlength=HI_SIZE + 1)[:HI_SIZE])
    return torch.stack(out).to(torch.int32)


def saturate_u8(counts: torch.Tensor) -> torch.Tensor:
    """Saturating u8 view of exact counts (the reference's saturating
    increment commutes with counting, so one clamp at the end is exact)."""
    return counts.clamp(max=255).to(torch.uint8)


def histogram_hi_max(
    counts: torch.Tensor,
    sel: tuple[bool, bool, bool],
    n_pixels: int | torch.Tensor,
    level_fixed: int,
    level_ratio_permille: int,
) -> torch.Tensor:
    """Normalisation ceiling, (3,) int64 (``stats.histogram_hi_max``, which
    returns uint32).  Ratio mode is ``floor(n * permille / 1000)`` in int64:
    the u32 product overflows above ~4.3 M pixels.  ``n_pixels`` is a host
    integer or a 0-d integer tensor on the counts' device (a dynamic rect's
    pixel count, never read on the host)."""
    counts = _as_device_arg(counts)
    dev = counts.device
    if level_fixed > 0:
        return torch.full((3,), max(1, int(level_fixed)), dtype=torch.int64, device=dev)
    if level_ratio_permille > 0:
        if isinstance(n_pixels, torch.Tensor):
            v = (n_pixels.to(torch.int64) * int(level_ratio_permille)) // 1000
            return v.clamp(min=1).reshape(1).expand(3).contiguous()
        v = max(1, (int(n_pixels) * int(level_ratio_permille)) // 1000)
        return torch.full((3,), v, dtype=torch.int64, device=dev)
    hi = counts.to(torch.int64).amax(dim=1).clamp(min=1)
    return torch.stack([hi[c] if sel[c] else torch.ones_like(hi[c]) for c in range(3)])


def histogram_levels(
    counts: torch.Tensor, hi_max: torch.Tensor, sel: tuple[bool, bool, bool], logscale: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 draw levels (3, 256) and effective hi_max (3,)
    (``stats.histogram_levels``)."""
    counts = _as_device_arg(counts)
    hi_max = _as_device_arg(hi_max, counts.device)
    cf = counts.to(torch.float32)
    if logscale:
        s = 1.0 / torch.log(hi_max.to(torch.float32) + 1.0)
        lv = torch.where(counts > 0, torch.log(cf + 1.0) * s[:, None], 0.0)
        lv = torch.stack([lv[c] if sel[c] else torch.zeros_like(lv[c]) for c in range(3)])
        return lv, torch.ones((3,), dtype=torch.float32, device=counts.device)
    return cf, hi_max.to(torch.float32)


def select_planes(
    planes: torch.Tensor, yuv_planes: torch.Tensor | None, is_yuv: bool
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(data (3, H, W), mask (H, W) bool) per component family
    (``stats.select_planes``).

    The YUV family never skips (the reference's conversion writes alpha 1),
    so its mask is all true; the RGB family's mask is alpha != 0."""
    planes = _as_device_arg(planes)
    if is_yuv:
        if yuv_planes is None:
            raise ValueError("the YUV family needs yuv_planes")
        yuv_planes = _as_device_arg(yuv_planes, planes.device)
        return yuv_planes, torch.ones(yuv_planes.shape[-2:], dtype=torch.bool,
                                      device=yuv_planes.device)
    return planes[..., :3, :, :], planes[..., 3, :, :] != 0


def apply_channel_select(counts: torch.Tensor, sel: tuple[bool, bool, bool]) -> torch.Tensor:
    """Zero the disabled channels (``stats.apply_channel_select``).  Built
    from the channels themselves, so no host data crosses to the device (a
    CUDA graph can capture it)."""
    counts = _as_device_arg(counts)
    return torch.stack([counts[c] if sel[c] else torch.zeros_like(counts[c]) for c in range(3)])
