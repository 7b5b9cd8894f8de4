"""One-pass frame analysis: every requested statistic from one frame.

Counterpart of ``obs_color_monitor_tpu/ops/fused.py`` (``AnalysisResult``
``:45``, ``analyze`` ``:77``).  Static flags pick the statistics.  One
route: kernel K1 without overlays (``ops/pipeline.frame_pass``) gives the
scaled planes and their Q12 YUV planes; they are cropped to the static
rect, if any; then K2 runs once per component family, in the mode the
TPU's kernels K2 or K6 (both counts), K7 (vectorscope alone) or K8
(waveform alone) would have run.  The JAX fast path (``:135-162``) runs a
different Pallas kernel; here it is the same K1 + K2 launches, so it needs
no branch of its own.  A dynamic rect (``rect_dyn``) goes to K2, which
reads it on the device: K1 has no statistics here, so it needs none.

The input's device picks the route, as in every kernel wrapper: a CUDA
tensor launches the kernels, a CPU tensor runs their plain versions.
``backend`` names that route for JAX's callers and never picks another
(:func:`default_backend`); a host array goes to the device of the route it
names, or to the default device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .convert import _as_device_arg, _default_device, packed_view
from .pipeline import frame_pass, stats_inputs
from .scope_stats import histogram_from_waveform, vs_wv_counts
from .stats import saturate_u8


# device type -> the route its tensors take, under JAX's backend names
_ROUTES = {"cuda": "pallas", "cpu": "xla"}


def default_backend() -> str:
    """The route a tensor on the default device takes, under JAX's names
    (``ops/fused.py:39-42``): ``"pallas"`` (the hand-written CUDA kernels)
    when a CUDA GPU is available, else ``"xla"`` (their plain PyTorch
    versions).  It reports the route; the input's device picks it, and a
    host array goes to the default device."""
    return _ROUTES[_default_device()]


def _host_array_device(backend: str | None) -> str:
    """Where a host array goes: the device of the route ``backend`` names,
    the default device (a CUDA GPU when there is one) without it.  An
    unknown name leaves it on the CPU, where :func:`analyze` refuses it."""
    if backend is None:
        backend = default_backend()
    return {route: dev for dev, route in _ROUTES.items()}.get(backend, "cpu")


class AnalysisResult(NamedTuple):
    """Per-frame statistics; entries are None unless requested.

    ``planes``/``yuv_planes`` are planar (C, h, w) u8.  The histograms are
    int32 here (the JAX fields are uint32; torch's uint32 lacks arithmetic
    on the CPU)."""

    yuv_planes: torch.Tensor | None  # (3, h, w) u8
    vs_counts: torch.Tensor | None  # (256, 256) u8
    wv_rgb: torch.Tensor | None  # (3, 256, w) u8
    wv_yuv: torch.Tensor | None
    hi_rgb: torch.Tensor | None  # (3, 256) int32
    hi_yuv: torch.Tensor | None
    planes: torch.Tensor | None  # the scaled/cropped frame (4, h, w)


def analyze(
    frame: torch.Tensor,
    cs: int,
    scale: int = 1,
    rect: tuple[int, int, int, int] | None = None,
    need_vs: bool = False,
    need_wv_rgb: bool = False,
    need_wv_yuv: bool = False,
    need_hi_rgb: bool = False,
    need_hi_yuv: bool = False,
    keep_rgba: bool = True,
    backend: str | None = None,
    is_planar: bool = False,
    is_packed: bool = False,
    tm=None,
    rect_dyn=None,
) -> AnalysisResult:
    """One pass: downscale -> crop -> convert -> statistics.

    frame: (H, W, 4) u8 RGBA or its (H, W) int32/uint32 packed view (the
    frame's shape tells them apart; ``is_packed`` requires the packed
    view), or (4, H, W) planar with ``is_planar``; a host array goes to the
    device of the route ``backend`` names, without it to the default device
    (a CUDA GPU when there is one).  ``rect`` is the ROI (x0, y0, x1, y1) in scaled
    coordinates.  ``planes`` holds the scaled (cropped) frame, or None
    without ``keep_rgba``.  ``backend`` names the route of the frame's
    device (``"pallas"`` for a CUDA tensor, ``"xla"`` for a CPU tensor,
    None for either); any other value or pairing raises.  ``tm``, a float or a 0-d
    tensor, changes no result (JAX threads its clock through its kernel);
    it is never read on the host.

    ``rect_dyn`` is a dynamic ROI in scaled coordinates, a (4,) integer
    tensor on the frame's device (exclusive with ``rect``): the statistics
    count only in-rect pixels, equal to the static crop's, the waveforms
    keep the full width with the columns outside the rect zero, and
    ``planes``/``yuv_planes`` stay the full capture.  The rect is never
    read on the host, so a new rect changes no launch shape
    (``analyze(rect_dyn=)``, ``ops/fused.py:107-113, 172-188``).
    """
    if rect is not None and rect_dyn is not None:
        raise ValueError("rect and rect_dyn are mutually exclusive")
    frame = _as_device_arg(frame, _host_array_device(backend))
    if backend is not None and _ROUTES.get(frame.device.type) != backend:
        raise ValueError(
            f"backend={backend!r} on a {frame.device} tensor: the frame's device picks the "
            "route ('pallas', the CUDA kernels, for a CUDA tensor; 'xla', their plain "
            "versions, for a CPU tensor)")
    if is_packed and (is_planar or frame.ndim != 2):
        raise ValueError(f"is_packed needs the (H, W) packed view, got shape "
                         f"{tuple(frame.shape)}{' with is_planar' if is_planar else ''}")
    if isinstance(tm, torch.Tensor) and tm.ndim != 0:
        raise ValueError(f"tm must be a float or a 0-d tensor, got shape {tuple(tm.shape)}")
    # an (H, W, 4) u8 frame goes to K1 as its packed view, without a copy
    x = frame if is_planar else packed_view(frame)
    ds, yuv, _, _, _ = frame_pass(x, packed=not is_planar, cs=int(cs), scale=int(scale),
                                  with_overlays=False)
    rgb_fam = need_wv_rgb or need_hi_rgb
    yuv_fam = need_wv_yuv or need_hi_yuv
    if rect_dyn is not None:
        rect_dyn = torch.as_tensor(rect_dyn, dtype=torch.int32, device=ds.device)
    if rect is not None:
        x0, y0, x1, y1 = rect
        ds = ds[:, y0:y1, x0:x1].contiguous()
        yuv = yuv[:, y0:y1, x0:x1].contiguous()
    vs = None
    counts = {}  # family -> (wv_i32 or None)
    # the vectorscope rides with the first family counted (K2/K6), or alone (K7)
    vs_pending = need_vs
    for fam, on in ((False, rgb_fam), (True, yuv_fam)):
        if not on:
            continue
        vs_i32, counts[fam] = vs_wv_counts(*stats_inputs(ds, yuv, fam), need_vs=vs_pending,
                                           rect=rect_dyn)
        if vs_pending:
            vs, vs_pending = saturate_u8(vs_i32), False
    if vs_pending:
        vs = saturate_u8(vs_wv_counts(yuv[1], yuv[2], None, None, need_wv=False,
                                      rect=rect_dyn)[0])

    def wv(fam, need):
        return saturate_u8(counts[fam]) if need else None

    def hi(fam, need):
        return histogram_from_waveform(counts[fam]) if need else None

    need_yuv = need_vs or yuv_fam
    return AnalysisResult(
        yuv_planes=yuv if need_yuv else None,
        vs_counts=vs,
        wv_rgb=wv(False, need_wv_rgb),
        wv_yuv=wv(True, need_wv_yuv),
        hi_rgb=hi(False, need_hi_rgb),
        hi_yuv=hi(True, need_hi_yuv),
        planes=ds if keep_rgba else None,
    )
