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

The port has no backend switch: the input's device picks the route, as in
every kernel wrapper (a CPU tensor runs the plain versions).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .convert import packed_view
from .pipeline import frame_pass, stats_inputs
from .scope_stats import histogram_from_waveform, vs_wv_counts
from .stats import saturate_u8


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
    planes: torch.Tensor  # the scaled/cropped frame (4, h, w), always kept


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
    is_planar: bool = False,
    rect_dyn=None,
) -> AnalysisResult:
    """One pass: downscale -> crop -> convert -> statistics.

    frame: (H, W, 4) u8 RGBA or its (H, W) int32/uint32 packed view (the
    frame's shape tells them apart), or (4, H, W) planar with
    ``is_planar``.  ``rect`` is the ROI (x0, y0, x1, y1) in scaled
    coordinates.  ``planes`` always holds the scaled (cropped) frame.

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
        planes=ds,
    )
