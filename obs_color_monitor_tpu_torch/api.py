"""High-level one-shot API: the full six-scope step and its batched form.

Counterpart of ``obs_color_monitor_tpu/api.py`` (``ScopeOutputs`` ``:34``,
``make_full_step`` ``:46``, ``make_batched_step`` ``:300``).  One frame in,
every scope's statistics and rendered images out.  On a CUDA device the
step runs kernel K1 (the whole-frame pass), K2 (vectorscope + waveform
counting) once per component family in use, K4/K5 in front of them for
NV12/P010 input, and plain torch for the glue (saturation, histogram,
hi_max, levels, renders), all captured once as a CUDA graph and replayed
(``graphs.py``, the counterpart of ``@jax.jit``).  The batched step runs
each kernel once for the whole batch.  On the CPU the same steps run the
kernels' plain versions, uncaptured.

A step takes what the JAX step takes: tensors on its device, or host
arrays (numpy, JAX, anything ``np.asarray`` takes), copied to the device
by the port's one conversion (``ops.convert._as_device_arg``; a captured
step copies them straight into its graph's input buffers).  A host array
never moves a step off its device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .colorspace import Colorspace, calc_colorspace, quantize_unorm8
from .config import (
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    VectorscopeConfig,
    WaveformConfig,
    ZebraConfig,
)
from .golden.reference import peaking_threshold_fixed
from .ops import render as render_ops
from .ops.convert import _as_device_arg, nv12_to_packed, packed_view, planarize_packed
from .ops.overlays import falsecolor_lut_planes
from .ops.pipeline import frame_pass, stats_inputs
from .ops.scope_stats import histogram_from_waveform, vs_wv_counts
from .ops.stats import apply_channel_select, saturate_u8

INPUT_FORMATS = ("rgba", "packed", "planar", "nv12")


class ScopeOutputs(NamedTuple):
    """The step's outputs: the JAX ``ScopeOutputs`` fields, shapes and dtypes."""

    vectorscope: torch.Tensor  # (256, 256, 4) u8
    waveform: torch.Tensor  # (256, W', 4) u8
    histogram: torch.Tensor  # (H', 256, 4) u8
    zebra: torch.Tensor  # full-res PLANAR (4, H, W) u8
    falsecolor: torch.Tensor  # (4, H, W) u8
    focuspeaking: torch.Tensor  # (4, H, W) u8
    vs_counts: torch.Tensor  # (256, 256) u8
    wv_counts: torch.Tensor  # (3, 256, W) u8
    hi_counts: torch.Tensor  # (3, 256) u32

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Every field as a host numpy array, by field name."""
        return {k: v.detach().cpu().numpy() for k, v in self._asdict().items()}


def check_device(t: torch.Tensor, device: torch.device) -> None:
    """Raise unless ``t`` lies on ``device`` (any card of its type when the
    device has no index)."""
    if t.device.type != device.type or (
        device.index is not None and t.device.index != device.index
    ):
        raise ValueError(f"frame is on {t.device}, the step on {device}")


def frame_from_numpy(arr, input_format: str, device):
    """A host frame as the step's input on ``device``: ``rgba`` (H, W, 4)
    u8, ``packed`` (H, W) u32 or int32 (held as int32), ``planar``
    (4, H, W) u8, ``nv12`` a (y, uv) pair of u8 or u16 planes (a pair of
    tensors).  A step takes the host frame as well; this is the copy it
    makes."""
    if input_format not in INPUT_FORMATS:
        raise ValueError(f"unknown input_format {input_format!r}")
    if input_format == "nv12":
        return tuple(_as_device_arg(a, device) for a in arr)
    return _as_device_arg(arr, device)


def _step_parts(
    height: int,
    width: int,
    cs: Colorspace = Colorspace.BT709,
    scale: int = 2,
    vectorscope: VectorscopeConfig | None = None,
    waveform: WaveformConfig | None = None,
    histogram: HistogramConfig | None = None,
    zebra: ZebraConfig | None = None,
    falsecolor: FalseColorConfig | None = None,
    focuspeaking: FocusPeakingConfig | None = None,
    input_format: str = "rgba",
    nv12_shift: int = 0,
    *,
    device="cuda",
):
    """The full step's parts for a fixed frame shape, shared by the single
    and the batched step: (device, frame shape, decode, kernels, glue,
    use_lut).  ``decode``
    turns the input (one frame or a batch) into K1's packed or planar
    view; ``kernels`` runs K1 and K2 on it (a batch in one launch each) and
    returns (vs, wv, hi counts, zebra, falsecolor, focuspeaking); ``glue``
    makes one frame's ScopeOutputs from one frame's slices of those."""
    if input_format not in INPUT_FORMATS:
        raise ValueError(f"unknown input_format {input_format!r}")
    device = torch.device(device)
    vs_cfg = vectorscope or VectorscopeConfig()
    wv_cfg = waveform or WaveformConfig()
    hi_cfg = histogram or HistogramConfig()
    zb_cfg = zebra or ZebraConfig()
    fc_cfg = falsecolor or FalseColorConfig()
    fp_cfg = focuspeaking or FocusPeakingConfig()

    cs = int(calc_colorspace(cs))
    # overlay scopes draw with their own colorspace property (reference
    # zbs_render uses src->cm.colorspace, src/zebra.c:620)
    zb_cs = int(calc_colorspace(zb_cfg.colorspace))
    fc_cs = int(calc_colorspace(fc_cfg.colorspace))
    sel = hi_cfg.components.channel_select()
    wv_sel = wv_cfg.components.channel_select()
    wv_yuv = wv_cfg.components.is_yuv
    hi_yuv = hi_cfg.components.is_yuv
    peak_rgba = tuple(int(v) for v in quantize_unorm8(np.asarray(fp_cfg.peaking_rgba, np.float32)))
    use_lut = fc_cfg.use_lut and fc_cfg.lut is not None
    lut = torch.as_tensor(fc_cfg.lut, device=device) if use_lut else None
    packed = input_format != "planar"  # nv12 decodes to the packed view
    n_scaled = (width // scale) * (height // scale)
    pass_kw = dict(
        packed=packed, cs=cs, scale=scale, with_overlays=True,
        th_low=zb_cfg.th_low, th_high=zb_cfg.th_high, zb_cs=zb_cs, fc_cs=fc_cs,
        peak_th=peaking_threshold_fixed(fp_cfg.peaking_threshold), peak_rgba=peak_rgba,
    )

    frame_shape = {"rgba": (height, width, 4), "packed": (height, width),
                   "planar": (4, height, width), "nv12": (height, width)}[input_format]

    def decode(frame):
        if input_format == "nv12":
            return nv12_to_packed(frame[0], frame[1], cs=cs, shift=nv12_shift)
        if input_format == "rgba":
            return packed_view(frame)
        return frame

    def kernels(x, tm):
        ds, yuv, zb_img, fc_img, fp_img = frame_pass(x, tm, **pass_kw)
        # K2 once per component family in use (twice only when the
        # waveform and histogram families differ); the vectorscope is
        # counted only with the waveform's family, whose result it reads
        counts = {}
        for fam in {wv_yuv, hi_yuv}:
            counts[fam] = vs_wv_counts(*stats_inputs(ds, yuv, fam), need_vs=fam == wv_yuv)
        return (counts[wv_yuv][0], counts[wv_yuv][1], counts[hi_yuv][1],
                zb_img, fc_img, fp_img)

    def glue(x, vs_i32, wv_i32, hi_wv_i32, zb_img, fc_img, fp_img) -> ScopeOutputs:
        vs_u8 = saturate_u8(vs_i32)
        wv_u8 = saturate_u8(wv_i32)
        hi_raw = histogram_from_waveform(hi_wv_i32)
        # the three images as one job table: KR's one launch on a card
        vs_img, wv_img, hi_img = render_ops.draw_stat_images([
            render_ops.vectorscope_job(vs_u8, None, intensity=vs_cfg.intensity, cs=cs,
                                       white=vs_cfg.color_type == 0),
            render_ops.waveform_job(wv_u8, None, wv_sel, intensity=wv_cfg.intensity,
                                    display=int(wv_cfg.display),
                                    n_components=wv_cfg.components.n_components,
                                    yuv_mode=wv_yuv),
            render_ops.histogram_job(hi_raw, None, sel, n_scaled,
                                     level_fixed=hi_cfg.level_fixed,
                                     level_ratio_permille=hi_cfg.level_ratio_permille,
                                     logscale=hi_cfg.logscale,
                                     level_height=hi_cfg.level_height,
                                     display=int(hi_cfg.display),
                                     n_components=hi_cfg.components.n_components,
                                     yuv_mode=hi_yuv),
        ])
        wv_counts = apply_channel_select(wv_u8, wv_sel)
        hi_counts = apply_channel_select(hi_raw, sel)
        if use_lut:
            planes = planarize_packed(x) if packed else x
            fc_img = falsecolor_lut_planes(planes, lut, cs=fc_cs, lut_n=lut.shape[0])
        return ScopeOutputs(
            vectorscope=vs_img,
            waveform=wv_img,
            histogram=hi_img,
            zebra=zb_img,
            falsecolor=fc_img,
            focuspeaking=fp_img,
            vs_counts=vs_u8,
            wv_counts=wv_counts,
            hi_counts=hi_counts.to(torch.uint32),
        )

    return device, frame_shape, decode, kernels, glue, use_lut


def _check_frame(frame, input_format: str, frame_shape: tuple, device, lead: tuple = ()):
    """The step's input on ``device`` (a host array copied there); raise
    unless a tensor lies there and the input has ``lead`` + ``frame_shape``
    (the y plane's, for NV12)."""
    planes = tuple(frame) if input_format == "nv12" else (frame,)
    planes = tuple(_as_device_arg(t, device) for t in planes)
    for t in planes:
        check_device(t, device)
    if tuple(planes[0].shape) != (*lead, *frame_shape):
        raise ValueError(f"{input_format} frame must be {(*lead, *frame_shape)}, got "
                         f"{tuple(planes[0].shape)}")
    return planes if input_format == "nv12" else planes[0]


def make_full_step(
    height: int,
    width: int,
    cs: Colorspace = Colorspace.BT709,
    scale: int = 2,
    vectorscope: VectorscopeConfig | None = None,
    waveform: WaveformConfig | None = None,
    histogram: HistogramConfig | None = None,
    zebra: ZebraConfig | None = None,
    falsecolor: FalseColorConfig | None = None,
    focuspeaking: FocusPeakingConfig | None = None,
    input_format: str = "rgba",
    nv12_shift: int = 0,
    *,
    device="cuda",
):
    """Build a (frame, tm) -> ScopeOutputs step for a fixed frame shape.

    Statistics run on the ``scale``-downscaled frame (any integer scale);
    overlays run at full resolution.  ``device`` is where the step runs.
    A frame is a tensor on ``device`` or a host array (numpy, JAX), which
    the step copies there; a tensor on another device raises.  input_format:

      * "rgba"   — (H, W, 4) u8, read as its packed view (no copy);
      * "packed" — the (H, W) 32-bit view of the RGBA bytes, int32 or
        uint32 (``frame_from_numpy`` / ``ops.convert.host_packed_view``);
      * "planar" — (4, H, W) u8;
      * "nv12"   — a (y (H, W), uv (H/2, W)) pair of u8 planes, decoded on
        the device in colorimetry ``cs`` to the packed view; with
        ``nv12_shift`` > 0, P010-family u16 planes, round-shifted to 8 bits
        in the same decode (``ops.convert.nv12_shift``).

    ``tm`` is the zebra stripe clock: a Python or numpy number, a 0-d
    host array, or a 0-d float32 tensor on ``device`` (the kernels read it
    from device memory).

    On a CUDA device the step is captured as a CUDA graph on its first call
    and replayed after (``graphs.CapturedStep``; one program per frame, as
    ``@jax.jit`` makes it): each call copies the frame and ``tm`` into the
    graph's buffers and returns fresh outputs.  ``step.eager`` is the
    uncaptured step.
    """
    from .graphs import captured

    device, frame_shape, decode, kernels, glue, _ = _step_parts(
        height, width, cs, scale, vectorscope, waveform, histogram, zebra, falsecolor,
        focuspeaking, input_format, nv12_shift, device=device)

    def step(frame, tm) -> ScopeOutputs:
        x = decode(_check_frame(frame, input_format, frame_shape, device))
        return glue(x, *kernels(x, tm))

    return captured(step, device)


def make_batched_step(height: int, width: int, mesh=None, *, device=None, **kwargs):
    """Multi-stream serving: (frames, tms (B,)) -> ScopeOutputs with a
    leading B on every field (``api.make_batched_step``, JAX's ``vmap`` of
    the step).

    ``kwargs`` are :func:`make_full_step`'s.  ``frames`` is a batch in the
    step's input format: (B, H, W, 4) u8 rgba, (B, H, W) packed, (B, 4, H, W)
    planar, or an NV12/P010 pair ((B, H, W), (B, H/2, W)); ``tms`` a (B,)
    float32 array, frame b's zebra clock.  Each is a tensor on the step's
    device or a host array, copied there.  K4/K5, K1
    and K2 each run once for the whole batch (the batch is their grid's
    frame axis, as ``vmap`` adds a grid axis to a ``pallas_call``); the glue
    runs frame by frame.  Frame b's outputs equal the full step's on frame
    b.  On a CUDA device the step is captured per B
    (``graphs.CapturedStep``); ``step.eager`` is the uncaptured step.

    ``device`` defaults to "cuda".  With a ``mesh`` (``parallel.make_mesh``,
    batch data-parallel, JAX's batch-sharded step) the step runs on this
    rank's device (``parallel.mesh_device``; a ``device`` of another type
    raises) and takes this rank's shard of the global batch
    (``parallel.shard_batch`` of the frames and of the clocks): B is the
    local batch, the results stay on the rank, and no collective runs, so
    the step is captured as without a mesh."""
    if mesh is not None:
        from .parallel.mesh import mesh_device

        mesh_dev = mesh_device(mesh)
        if device is not None and torch.device(device).type != mesh_dev.type:
            raise ValueError(f"make_batched_step: device {device} but a {mesh_dev.type} mesh")
        device = mesh_dev
    elif device is None:
        device = "cuda"
    from .graphs import captured

    input_format = kwargs.get("input_format", "rgba")
    device, frame_shape, decode, kernels, glue, use_lut = _step_parts(
        height, width, device=device, **kwargs)

    def step(frames, tms) -> ScopeOutputs:
        lead = np.shape(frames[0] if input_format == "nv12" else frames)
        if len(lead) != len(frame_shape) + 1 or lead[0] < 1:
            raise ValueError(f"frames must be (B, {', '.join(map(str, frame_shape))}), got "
                             f"{tuple(lead)}")
        b = lead[0]
        frames = _check_frame(frames, input_format, frame_shape, device, (b,))
        tms = _as_device_arg(tms, device)
        if tuple(tms.shape) != (b,) or tms.dtype != torch.float32:
            raise ValueError(f"tms must be a ({b},) float32 array, got {tuple(tms.shape)} "
                             f"{tms.dtype}")
        x = decode(frames)
        parts = kernels(x, tms)
        outs = [glue(x[i], *(t[i] for t in parts)) for i in range(b)]
        # K1's overlay planes are batched already (the user-LUT false colour
        # is the glue's); the glue's per-frame outputs are stacked
        batched = dict(zebra=parts[3], focuspeaking=parts[5])
        if not use_lut:
            batched["falsecolor"] = parts[4]
        return ScopeOutputs(*(batched[k] if k in batched else torch.stack(f)
                              for k, f in zip(ScopeOutputs._fields, zip(*outs))))

    return captured(step, device)
