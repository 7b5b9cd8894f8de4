#!/usr/bin/env python3
"""Drive the torch port's six-scope step and dock panel on one CUDA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA GPU and exits non-zero without one.  Phases, in order;
any failure raises and the exit code is non-zero:

1. versions, and the card's name and power limit from nvidia-smi;
2. build the CUDA kernels from ``obs_color_monitor_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel; ptxas' resource use per kernel);
3. each kernel against its plain PyTorch version on the card, with
   ``torch.equal`` on every output: K1/K2 over shapes (4K and odd sizes),
   scales 1/2/3/4/8, both component families, BT601 and BT709, packed and
   planar input, random / flat-grey / colour-bar frames with alpha-0
   regions; K4 and K5 (NV12 / P010 decode) at 4K and small shapes, every
   depth; K3 (the three overlays) at 4K, 1080p and odd shapes, planar and
   packed output, with and without a rect; K2's vectorscope alone (K7),
   waveform alone (K8) and both (K6) on cropped planes; K2 in its three
   modes and K3 with a dynamic rect (a (4,) int32 tensor on the card) at
   1920x1080 and odd shapes, over rects inside, full, one pixel, empty,
   touching each edge, oversized and reversed; K9 (the fused ingest
   statistics) at scale 2 on 3840x2160 and scale 1 on 1920x1080 and odd
   shapes, and one 270x480 case against the golden model;
4. the main paths, each on the card and on the CPU, every output field
   equal, the launch counters set to 0 just before each path and read just
   after it (every kernel of the path must have launched):
   ``make_full_step(2160, 3840, scale=2, input_format="packed")``;
   ``make_dock_step(2160, 3840, scale=2, input_format="nv12",
   dock=DockConfig(show_focuspeaking=True))`` on NV12 frames and its P010
   form; rgba with a static ROI, full-resolution overlays, a
   vectorscope-only dock and ``make_full_step(input_format="nv12")``;
   ``fused_ingest_stats_scale2`` on 4K planar frames; the dynamic-ROI dock
   step (``dynamic_roi=True``) over a 6-rect drag, the same launches for
   every rect, equal at the ROI to the static ``roi_rect`` step, and one
   step captured in a CUDA graph, replayed for the later rects with the
   rect tensor overwritten in place; the streaming ``models.Dock`` on 6
   4K NV12 frames with a move-drag on its ROI band, against a CPU Dock fed
   the same frames and mouse events; one 270x480 frame against the golden
   model;
5. timing with CUDA events (warm-up, then the median of 25 runs of 10
   back-to-back calls): the 4K full step, the 4K NV12 dock step, its
   dynamic-ROI form eagerly and as a CUDA graph replay, per frame; each
   kernel beside its plain version and, where one exists, the one PyTorch
   call that computes the same function (K2 and K3 also in rect mode); then
   each kernel's device time alone, from torch.profiler;
6. a torch.profiler window over 10 full steps, 10 NV12 and 10 P010 dock
   steps: device time per kernel and the device's busy share of the
   window.

Then one JSON line with the per-kernel results, the card line, and as the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

H4K, W4K = 2160, 3840
STEP_FRAMES = 8
TIMING_REPS = 25
OV_ARGS = dict(th_low=0.75, th_high=1.0, zb_cs=2, fc_cs=2, peak_th=3062,
               peak_rgba=(255, 84, 0, 255))
ROI = (240, 135, 1680, 945)  # the ROI run's static rect, scaled coordinates
DRAG_FRAMES = 6  # frames of the dynamic-ROI and streaming-Dock paths
# the bound of each kernel: the NVIDIA H100 SXM's published HBM rate and
# its peak for 32-bit operations outside the tensor cores (the float32
# figure of NVIDIA's data sheet; the kernels' integer ops issue on the same
# CUDA cores)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def card_line() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi prints it."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = res.stdout.strip().splitlines()
    return lines[0].strip() if lines else f"nvidia-smi failed ({res.returncode})"


def make_frame(h: int, w: int, kind: str, seed: int) -> np.ndarray:
    """(h, w, 4) RGBA u8: ``random`` (with an alpha-0 block and scattered
    alpha-0 pixels), ``flat`` (mid grey, opaque: every pixel in one bin) or
    ``bars`` (the 75% colour bars, an alpha-0 band at the bottom)."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        f = np.full((h, w, 4), 128, np.uint8)
        f[..., 3] = 255
        return f
    if kind == "bars":
        bars = np.array([[191, 191, 191], [191, 191, 0], [0, 191, 191], [0, 191, 0],
                         [191, 0, 191], [191, 0, 0], [0, 0, 191], [0, 0, 0]], np.uint8)
        f = np.empty((h, w, 4), np.uint8)
        f[..., :3] = bars[(np.arange(w) * 8) // w][None]
        f[..., 3] = 255
        f[h - max(1, h // 8):, :, 3] = 0
        return f
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.05, 0, 255)
    f[: h // 5, : w // 5, 3] = 0
    return f


def make_nv12(h: int, w: int, seed: int, bits: int = 8, msb: bool = False):
    """(y (h, w), uv (h/2, w)) random planes: u8 with the fixed-point
    boundary samples of the decode (limited-range ends, neutral chroma), or
    u16 ``bits``-bit samples (shifted to the top with ``msb``) with a few
    samples at 65535, past any depth."""
    rng = np.random.default_rng(seed)
    if bits == 8:
        y = rng.integers(0, 256, (h, w), np.uint8)
        uv = rng.integers(0, 256, (h // 2, w), np.uint8)
        y[0, : min(3, w)] = (0, 16, 255)[: min(3, w)]
        uv[0, : min(4, w)] = (0, 255, 128, 128)[: min(4, w)]
        return y, uv
    y = rng.integers(0, 1 << bits, (h, w)).astype(np.uint16)
    uv = rng.integers(0, 1 << bits, (h // 2, w)).astype(np.uint16)
    if msb:
        y, uv = (y << (16 - bits)).astype(np.uint16), (uv << (16 - bits)).astype(np.uint16)
    y[0, :2] = uv[0, :2] = 65535
    return y, uv


def as_input(f: np.ndarray, packed: bool, device):
    import torch

    arr = f.view(np.int32)[..., 0] if packed else np.ascontiguousarray(np.moveaxis(f, -1, 0))
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def to_device(arrays, device):
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def max_abs_err(a, b) -> int:
    """Largest difference of two outputs, element by element; packed int32
    images compare byte by byte (one bad channel is off by at most 255)."""
    import torch

    if a is None and b is None:
        return 0
    if a.dtype == torch.int32:
        a, b = a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def check_equal(kernel: str, case: str, got, ref, err: dict) -> None:
    """Record the kernel's error against its plain version; raise unless
    every output is equal."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    e = max(max_abs_err(a, b) for a, b in zip(got, ref))
    eq = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, ref))
    print(f"{kernel} {case}: equal={eq}", flush=True)
    if not eq:
        raise AssertionError(f"{kernel} differs from its plain version in case {case}: "
                             f"max err {e}")
    err[kernel] = max(err.get(kernel, 0), e)


def kernel_cases():
    """K1/K2 cases: (h, w, scale, yuv_data, cs, kind, packed, tm)."""
    kinds = ("random", "flat", "bars")
    cases = [
        (H4K, W4K, 2, False, 2, "random", True, 0.0667),
        (H4K, W4K, 2, True, 1, "flat", True, 11.9),
        (H4K, W4K, 1, False, 2, "bars", False, 2.5),
        (H4K, W4K, 3, True, 2, "random", True, 5.0),
        (H4K, W4K, 4, False, 1, "random", False, 7.25),
        (H4K, W4K, 8, False, 2, "bars", True, 0.5),
    ]
    i = 0
    for h, w in ((131, 270), (13, 17), (65, 144), (140, 270)):
        for scale in (1, 2, 3, 4, 8):
            cases.append((h, w, scale, bool(i % 2), 1 + (i // 2) % 2, kinds[i % 3],
                          bool((i // 3) % 2), 0.37 * i))
            i += 1
    return cases


def phase_kernels(device, cases, err: dict) -> None:
    """K1 and K2 vs their plain versions on ``device``."""
    from obs_color_monitor_tpu_torch.ops import pipeline as pl
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    for n, (h, w, scale, yuv, cs, kind, packed, tm) in enumerate(cases):
        x = as_input(make_frame(h, w, kind, n), packed, device)
        kw = dict(packed=packed, cs=cs, scale=scale, **OV_ARGS)
        ref = pl.frame_pass_reference(x, tm, **kw)
        name = (f"{n:2d} {h}x{w} scale {scale} {'yuv' if yuv else 'rgb'} cs {cs} {kind} "
                f"{'packed' if packed else 'planar'}")
        check_equal("K1", name, pl.frame_pass(x, tm, **kw), ref, err)
        inputs = pl.stats_inputs(ref[0], ref[1], yuv)
        check_equal("K2", name, ss.vs_wv_counts(*inputs), ss.vs_wv_counts_reference(*inputs),
                    err)


def phase_decode(device, err: dict) -> None:
    """K4 and K5 vs their plain versions."""
    from obs_color_monitor_tpu_torch.ops import convert as cv
    from obs_color_monitor_tpu_torch.ops import decode as dec

    for h, w in ((H4K, W4K), (2, 8), (48, 64), (130, 256), (66, 142)):
        for cs in (1, 2):
            y, uv = to_device(make_nv12(h, w, h + w + cs), device)
            check_equal("K4", f"{h}x{w} cs {cs}", dec.nv12_decode(y, uv, cs=cs),
                        cv.nv12_packed_reference(y, uv, cs), err)
    for h, w in ((H4K, W4K), (130, 254), (2, 4)):
        for bits, msb in ((10, False), (10, True), (12, False), (16, False)):
            shift = cv.nv12_shift(bits, msb)
            y, uv = to_device(make_nv12(h, w, h + bits, bits, msb), device)
            check_equal("K5", f"{h}x{w} {bits}-bit {'msb' if msb else 'lsb'} shift {shift}",
                        dec.nv12_16_decode(y, uv, cs=1 + bits % 2, shift=shift),
                        cv.nv12_16_packed_reference(y, uv, 1 + bits % 2, shift), err)


def overlay_cases():
    """K3 cases: (h, w, kind, packed_out, rect, zb_cs, fc_cs, outputs, tm)."""
    kinds = ("random", "flat", "bars")
    cases = []
    i = 0
    for h, w in ((H4K, W4K), (1080, 1920), (13, 17), (33, 17), (65, 144), (131, 270)):
        inside = (w // 5, h // 6, w - w // 4, h - h // 3)
        touching = (0, h // 3, w, h)  # left, right and bottom edges
        for packed_out in (False, True):
            for rect in (None, inside, touching):
                outputs = (True, True, True) if i % 4 else (True, False, True)
                cases.append((h, w, kinds[i % 3], packed_out, rect, 1 + i % 2,
                              1 + (i // 2) % 2, outputs, 0.43 * i))
                i += 1
    return cases


def phase_overlays(device, err: dict) -> None:
    """K3 vs its plain version."""
    from obs_color_monitor_tpu_torch.ops import fused_overlays as fo

    for n, (h, w, kind, packed_out, rect, zb_cs, fc_cs, outputs, tm) in enumerate(
            overlay_cases()):
        x = as_input(make_frame(h, w, kind, 50 + n), False, device)
        kw = dict(OV_ARGS, zb_cs=zb_cs, fc_cs=fc_cs, rect=rect, packed_out=packed_out,
                  outputs=outputs)
        check_equal("K3", f"{n:2d} {h}x{w} {kind} packed_out={packed_out} rect={rect} "
                    f"cs {zb_cs}/{fc_cs} outputs={outputs}",
                    fo.fused_overlays_planes(x, tm, **kw),
                    fo.fused_overlays_reference(x, tm, **kw), err)


def phase_stats_modes(device, err: dict) -> None:
    """K2's kernels alone (K7: vectorscope, K8: waveform) and together (K6)
    on cropped, then contiguous, scaled planes, both families."""
    from obs_color_monitor_tpu_torch.ops import pipeline as pl
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    for n, (h, w, kind, rect) in enumerate((
        (H4K, W4K, "random", ROI), (H4K, W4K, "flat", (0, 0, 1920, 540)),
        (131, 270, "bars", (3, 5, 120, 60)), (65, 144, "random", (0, 31, 72, 32)),
    )):
        x = as_input(make_frame(h, w, kind, 80 + n), True, device)
        ds, yuv, *_ = pl.frame_pass_reference(x, packed=True, cs=2, scale=2,
                                              with_overlays=False)
        x0, y0, x1, y1 = rect
        ds, yuv = ds[:, y0:y1, x0:x1].contiguous(), yuv[:, y0:y1, x0:x1].contiguous()
        for fam in (False, True):
            inputs = pl.stats_inputs(ds, yuv, fam)
            for kernel, need_vs, need_wv in (("K6", True, True), ("K7", True, False),
                                             ("K8", False, True)):
                kw = dict(need_vs=need_vs, need_wv=need_wv)
                check_equal(kernel, f"{h}x{w} {kind} crop {rect} {'yuv' if fam else 'rgb'}",
                            ss.vs_wv_counts(*inputs, **kw),
                            ss.vs_wv_counts_reference(*inputs, **kw), err)


def rect_cases(h: int, w: int, roi=None) -> list:
    """Dynamic rects on an (h, w) plane: inside (the ROI), the full plane,
    one pixel, empty, touching each edge, oversized and negative, reversed."""
    return [
        roi or (w // 8, h // 8, w - w // 8, h - h // 8), (0, 0, w, h),
        (w // 2, h // 2, w // 2 + 1, h // 2 + 1), (w // 3, h // 3, w // 3, h // 2),
        (0, h // 4, w // 3, h // 2), (w // 4, 0, w // 2, h // 3),
        (w // 2, h // 4, w, h // 2), (w // 4, h // 2, w // 2, h),
        (-w // 4, -h // 5, 2 * w, 3 * h), (w // 2, h // 2, w // 4, h // 4),
    ]


RECT_SHAPES = ((1080, 1920), (130, 190), (67, 190), (131, 270), (13, 17))


def phase_rect_kernels(device, err: dict) -> None:
    """K2 (both counts, the vectorscope alone as K7, the waveform alone as
    K8) and K3 with a dynamic rect tensor on the card vs their plain
    versions; the 1920x1080 planes are a 4K frame's scale-2 capture."""
    import torch

    from obs_color_monitor_tpu_torch.ops import fused_overlays as fo
    from obs_color_monitor_tpu_torch.ops import pipeline as pl
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    for n, (h, w) in enumerate(RECT_SHAPES):
        scale = 2 if h == H4K // 2 else 1
        x = as_input(make_frame(h * scale, w * scale, ("random", "bars")[n % 2], 400 + n),
                     True, device)
        ds, yuv, *_ = pl.frame_pass_reference(x, packed=True, cs=2, scale=scale,
                                              with_overlays=False)
        for r in rect_cases(h, w, ROI if scale == 2 else None):
            rect = torch.tensor(r, dtype=torch.int32, device=device)
            for fam in (False, True):
                inputs = pl.stats_inputs(ds, yuv, fam)
                for kernel, need_vs, need_wv in (("K2", True, True), ("K7", True, False),
                                                 ("K8", False, True)):
                    kw = dict(need_vs=need_vs, need_wv=need_wv, rect=rect)
                    check_equal(kernel, f"{h}x{w} rect {r} {'yuv' if fam else 'rgb'}",
                                ss.vs_wv_counts(*inputs, **kw),
                                ss.vs_wv_counts_reference(*inputs, **kw), err)
            for packed_out in (False, True):
                kw = dict(OV_ARGS, rect=rect, packed_out=packed_out)
                check_equal("K3", f"{h}x{w} rect tensor {r} packed_out={packed_out}",
                            fo.fused_overlays_planes(ds, 0.37 * n, **kw),
                            fo.fused_overlays_reference(ds, 0.37 * n, **kw), err)


def phase_ingest(device, err: dict) -> None:
    """K9, ``fused_ingest_stats`` (K1's scale launch, then K2), vs its plain
    route, and one 270x480 case against the golden model."""
    from obs_color_monitor_tpu_torch import Components, golden
    from obs_color_monitor_tpu_torch.ops import pipeline as pl

    cases = [(H4K, W4K, 2, kind, yuv) for kind in ("random", "flat") for yuv in (False, True)]
    cases += [(H4K // 2, W4K // 2, 1, kind, yuv) for kind in ("random", "flat")
              for yuv in (False, True)]
    cases += [(h, w, scale, "bars", (h + scale) % 2 == 0) for h, w in
              ((130, 190), (67, 190), (131, 270), (13, 17)) for scale in (1, 2)]
    for n, (h, w, scale, kind, yuv) in enumerate(cases):
        x = as_input(make_frame(h, w, kind, 500 + n), False, device)
        check_equal("K9", f"{h}x{w} scale {scale} {kind} {'yuv' if yuv else 'rgb'}",
                    pl.fused_ingest_stats(x, 1 + n % 2, scale, yuv),
                    pl.fused_ingest_stats_reference(x, 1 + n % 2, scale, yuv), err)
    f = make_frame(270, 480, "random", 9)
    vs, wv, ds = (t.cpu().numpy() for t in pl.fused_ingest_stats_scale2(
        as_input(f, False, device), 2))
    scaled = golden.downscale(f, 2)
    yuv = golden.rgb_to_yuv_u8(scaled, 2)
    for name, got, want in (
        ("vs", np.minimum(vs, 255), golden.vectorscope_counts(yuv)),
        ("wv", np.minimum(wv, 255), golden.waveform_counts(scaled, None, Components.RGB)),
        ("hi", wv.sum(axis=-1), golden.histogram_counts(scaled, None, Components.RGB)),
        ("ds", ds, np.moveaxis(scaled, -1, 0)),
    ):
        if not np.array_equal(got.astype(np.int64), want.astype(np.int64)):
            raise AssertionError(f"K9 golden check: {name} differs at 480x270")
    print("K9 golden: 480x270 vs, wv, hi and ds equal to the golden model", flush=True)


def read_counts() -> dict:
    """Every kernel wrapper's launch count; K2's kernel pair counts as
    ``both``, its kernels alone as K7 / K8."""
    from obs_color_monitor_tpu_torch.ops import decode, fused_overlays, pipeline, scope_stats

    vs = scope_stats.vs_wv_counts
    return {
        "K1": pipeline.frame_pass.launches,
        "both": vs.launches - vs.launches_vs_only - vs.launches_wv_only,
        "K7": vs.launches_vs_only,
        "K8": vs.launches_wv_only,
        "K2 rect": vs.launches_rect,
        "K3": fused_overlays.fused_overlays_planes.launches,
        "K3 rect": fused_overlays.fused_overlays_planes.launches_rect,
        "K4": decode.nv12_decode.launches,
        "K5": decode.nv12_16_decode.launches,
    }


def reset_counts() -> None:
    from obs_color_monitor_tpu_torch.ops import decode, fused_overlays, pipeline, scope_stats

    vs = scope_stats.vs_wv_counts
    pipeline.frame_pass.launches = 0
    vs.launches = vs.launches_vs_only = vs.launches_wv_only = vs.launches_rect = 0
    fo = fused_overlays.fused_overlays_planes
    fo.launches = fo.launches_rect = 0
    decode.nv12_decode.launches = decode.nv12_16_decode.launches = 0


def run_path(name: str, build, host_frames: list, fmt: str, device, needs: tuple,
             both_as: str = "K2") -> dict:
    """One main path: the step ``build(device)`` on every frame, its counts
    read around that run alone, then every output field against the same
    step on the CPU.  ``needs`` lists the kernels the path must launch;
    K2's kernel pair is booked as ``both_as`` (K2, or K6 off the fast
    path).  Returns the path's counts by kernel id."""
    import torch

    from obs_color_monitor_tpu_torch import frame_from_numpy

    step, step_cpu = build(device), build("cpu")
    dev_frames = [frame_from_numpy(f, fmt, device) for f in host_frames]
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_counts()
    outs = [step(x, i * 0.0667).to_numpy() for i, x in enumerate(dev_frames)]
    counts = path_counts(name, read_counts(), needs, device, both_as)
    for i, f in enumerate(host_frames):
        ref = step_cpu(frame_from_numpy(f, fmt, "cpu"), i * 0.0667).to_numpy()
        compare_fields(f"path {name} frame {i}", outs[i], ref)
    print(f"path {name}: all {len(ref)} fields equal to the CPU on {len(host_frames)} frames",
          flush=True)
    return counts


def compare_fields(what: str, got: dict, ref: dict) -> None:
    """Raise unless two dicts of host arrays have the same fields, each of
    the same shape, type and values, and finite."""
    if ref.keys() != got.keys():
        raise AssertionError(f"{what}: fields {sorted(got)}, expected {sorted(ref)}")
    for k, v in ref.items():
        g = got[k]
        if g.shape != v.shape or g.dtype != v.dtype or not np.array_equal(g, v):
            raise AssertionError(f"{what}: field {k} differs")
        if not np.isfinite(g.astype(np.float64)).all():
            raise AssertionError(f"{what}: {k} not finite")


def path_counts(name: str, counts: dict, needs: tuple, device, both_as: str = "K2") -> dict:
    """Book K2's pair as ``both_as``, print the path's counts and raise if
    a kernel it needs did not launch."""
    counts = dict(counts)
    counts[both_as] = counts.pop("both")
    print(f"path {name}: launches " + " ".join(f"{k}={v}" for k, v in sorted(counts.items())),
          flush=True)
    missing = [k for k in needs if counts.get(k, 0) < 1]
    if device.type == "cuda" and missing:
        raise AssertionError(f"path {name} did not launch {missing}: {counts}")
    return counts


def phase_ingest_path(device, h=H4K, w=W4K, frames=2) -> dict:
    """``fused_ingest_stats_scale2`` (K9) on 4K planar frames vs the CPU.
    K9 is K1's scale launch and K2, so its launches on this path are
    theirs, read from their wrappers' counts around this path alone."""
    import torch

    from obs_color_monitor_tpu_torch.ops import pipeline as pl

    host = [np.ascontiguousarray(np.moveaxis(make_frame(h, w, "random", 600 + i), -1, 0))
            for i in range(frames)]
    dev = [torch.from_numpy(a).to(device) for a in host]
    reset_counts()
    outs = [[t.cpu().numpy() for t in pl.fused_ingest_stats_scale2(x, 2)] for x in dev]
    name = "ingest_stats scale2"
    counts = path_counts(name, read_counts(), ("K1", "K2"), device)
    counts["K9"] = counts["K1"] + counts["K2"]
    for i, a in enumerate(host):
        ref = [t.numpy() for t in pl.fused_ingest_stats_scale2(torch.from_numpy(a), 2)]
        compare_fields(f"path {name} frame {i}", dict(zip("vwd", outs[i])), dict(zip("vwd", ref)))
    print(f"path {name}: vs, wv and ds equal to the CPU on {frames} frames", flush=True)
    return {name: counts}


def drag_rects(roi, n: int, step: tuple) -> list:
    """``n`` positions of a rect dragged by ``step`` per frame."""
    return [(roi[0] + k * step[0], roi[1] + k * step[1], roi[2] + k * step[0],
             roi[3] + k * step[1]) for k in range(n)]


def capture_graph(step, frame, rect):
    """One dynamic-ROI step captured in a CUDA graph (after two warm-up
    steps on a side stream, as torch.cuda.graph asks): (graph, its output)."""
    import torch

    side = torch.cuda.Stream(rect.device)
    side.wait_stream(torch.cuda.current_stream(rect.device))
    with torch.cuda.stream(side):
        for _ in range(2):
            step(frame, 1.0, rect)
    torch.cuda.current_stream(rect.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(frame, 1.0, rect)
    return graph, out


def phase_dynamic_dock(device, h=H4K, w=W4K, roi=ROI, frames=DRAG_FRAMES) -> dict:
    """The dynamic-ROI dock step over a drag: each frame equal to the CPU
    step at its rect, the same launches for every rect, equal at the ROI to
    the static roi_rect step; on a card, one step captured in a CUDA graph
    and replayed for the later rects (and the edge rects) with the rect
    tensor overwritten in place, equal to the eager step."""
    import torch

    from obs_color_monitor_tpu_torch import DockConfig, frame_from_numpy, make_dock_step

    def build(d, **kw):
        return make_dock_step(h, w, scale=2, input_format="nv12",
                              dock=DockConfig(show_focuspeaking=True), device=d, **kw)

    name = "dock nv12 dynamic_roi"
    step, step_cpu = build(device, dynamic_roi=True), build("cpu", dynamic_roi=True)
    sw, sh = w // 2, h // 2
    rects = drag_rects(roi, frames, (max(1, sw // 48), max(1, sh // 54)))
    host = [make_nv12(h, w, 700 + i) for i in range(frames)]
    dev = [frame_from_numpy(f, "nv12", device) for f in host]
    rect_t = [torch.tensor(r, dtype=torch.int32, device=device) for r in rects]
    reset_counts()
    outs, per_frame = [], []
    for x, r in zip(dev, rect_t):
        before = read_counts()
        outs.append(step(x, 1.0, r).to_numpy())
        per_frame.append({k: v - before[k] for k, v in read_counts().items()})
    counts = path_counts(name, read_counts(), ("K1", "K2", "K3", "K4", "K2 rect", "K3 rect"),
                         device)
    if any(c != per_frame[0] for c in per_frame):
        raise AssertionError(f"path {name}: launches differ between rects: {per_frame}")
    print(f"path {name}: the same launches for each of {frames} rects: {per_frame[0]}",
          flush=True)
    for i, (f, r) in enumerate(zip(host, rects)):
        ref = step_cpu(frame_from_numpy(f, "nv12", "cpu"), 1.0,
                       torch.tensor(r, dtype=torch.int32)).to_numpy()
        compare_fields(f"path {name} rect {r}", outs[i], ref)
    print(f"path {name}: all fields equal to the CPU at {frames} rects", flush=True)
    st = build(device, roi_rect=roi)(dev[0], 1.0).to_numpy()
    x0, x1 = roi[0], roi[2]
    for k, got, want in (("vs_counts", outs[0]["vs_counts"], st["vs_counts"]),
                         ("hi_counts", outs[0]["hi_counts"], st["hi_counts"]),
                         ("wv_counts", outs[0]["wv_counts"][:, :, x0:x1], st["wv_counts"])):
        if not np.array_equal(got, want):
            raise AssertionError(f"path {name}: {k} at the ROI differs from the roi_rect step")
    print(f"path {name}: at the ROI the statistics equal the static roi_rect step's",
          flush=True)
    if device.type == "cuda":
        graph_rects = rects[1:] + [(0, 0, sw, sh), (sw - 1, sh - 1, sw, sh),
                                   (-50, -20, 10 * sw, 10 * sh), (sw // 3, sh // 3, sw // 3, sh)]
        rect = torch.tensor(rects[0], dtype=torch.int32, device=device)
        graph, out = capture_graph(step, dev[0], rect)
        for r in graph_rects:
            rect.copy_(torch.tensor(r, dtype=torch.int32))
            graph.replay()
            eager = step(dev[0], 1.0, torch.tensor(r, dtype=torch.int32, device=device))
            compare_fields(f"path {name} graph replay rect {r}", out.to_numpy(),
                           eager.to_numpy())
        print(f"path {name}: a CUDA graph of one step, replayed for {len(graph_rects)} rects, "
              "equals the eager step at each", flush=True)
    return {name: counts}


def phase_stream_dock(device, h=H4K, w=W4K, roi=ROI, frames=DRAG_FRAMES) -> dict:
    """The streaming ``models.Dock`` fed NV12 frames through push_nv12 and
    render, a move-drag on its ROI band across the middle frames, against
    a CPU Dock fed the same frames and mouse events: every panel and the
    published vectorscope and histogram equal."""
    from obs_color_monitor_tpu_torch import DockConfig
    from obs_color_monitor_tpu_torch.config import ROIConfig
    from obs_color_monitor_tpu_torch.models import Dock

    name = "models.Dock nv12 stream + drag"
    docks = [Dock(DockConfig(show_focuspeaking=True), roi=ROIConfig(target_scale=2, interleave=0),
                  device=d) for d in (device, "cpu")]
    host = [make_nv12(h, w, 800 + i) for i in range(frames)]
    cx, cy = (roi[0] + roi[2]) // 2, (roi[1] + roi[3]) // 2
    dx, dy = max(1, w // 96), max(1, h // 108)

    def at(d, sx, sy):
        """The panel pixel over capture pixel (sx, sy) in the ROI band."""
        x0b, y0b, wb, hb, ws, hs = d._rects["roi"]
        ox, oy = d._roi_crop_origin
        return x0b + -(-(sx - ox) * wb // ws), y0b + -(-(sy - oy) * hb // hs)

    def events(d, i):
        if i == 2:
            d.hub.set_roi(*roi)
        elif i == 3:
            d.mouse_move(*at(d, cx, cy))
            d.mouse_down(*at(d, cx, cy))
        if i in (3, 4):
            d.mouse_move(*at(d, cx + (i - 2) * dx, cy + (i - 2) * dy))
        elif i == 5:
            d.mouse_up(*at(d, cx + 2 * dx, cy + 2 * dy))
            d.mouse_move(0, d.config.height - 1)  # park the pointer off the band

    reset_counts()
    for i, (y, uv) in enumerate(host):
        panels = []
        for d in docks:
            events(d, i)
            d.push_nv12(y, uv)
            panels.append(d.render())
        card, cpu = docks
        if not np.array_equal(*panels):
            raise AssertionError(f"path {name} frame {i}: the panel differs from the CPU Dock's")
        if not (np.array_equal(card.vectorscope._read().cpu().numpy(),
                               cpu.vectorscope._read().numpy())
                and np.array_equal(card.histogram.counts(), cpu.histogram.counts())):
            raise AssertionError(f"path {name} frame {i}: published statistics differ")
        print(f"path {name} frame {i}: rect {card.hub.config.resolve_rect(w // 2, h // 2)}, "
              f"dynamic {card.hub.last_surface.dynamic_rect is not None}: panel, vectorscope "
              "and histogram equal to the CPU Dock's", flush=True)
    counts = path_counts(name, read_counts(), ("K1", "K2", "K3", "K4", "K2 rect", "K3 rect"),
                         device)
    return {name: counts}


def phase_main_path(device, h=H4K, w=W4K, frames=STEP_FRAMES) -> dict:
    """The 4K scale-2 packed full step on ``device`` vs the CPU; returns
    {path: its counts by kernel id}."""
    from obs_color_monitor_tpu_torch import make_full_step

    host = [make_frame(h, w, "random", 100 + i).view(np.uint32)[..., 0] for i in range(frames)]
    name = "full_step packed"
    return {name: run_path(name, lambda d: make_full_step(
        h, w, scale=2, input_format="packed", device=d), host, "packed", device, ("K1", "K2"))}


def dock_paths(h=H4K, w=W4K, roi=ROI):
    """The dock paths: (name, builder, host frames, format, kernels it must
    launch, where K2's pair is booked)."""
    from obs_color_monitor_tpu_torch import (
        Components, DockConfig, HistogramConfig, make_dock_step, make_full_step)

    all6 = DockConfig(show_focuspeaking=True)
    vs_only = DockConfig(show_roi=False, show_waveform=False, show_histogram=False,
                         show_focuspeaking=True)
    dock = lambda **kw: (lambda d: make_dock_step(h, w, scale=2, device=d, **kw))
    rgba = [make_frame(h, w, "random", 300)]
    return [
        ("dock nv12", dock(input_format="nv12", dock=all6),
         [make_nv12(h, w, 200 + i) for i in range(4)], "nv12", ("K1", "K2", "K3", "K4"), "K2"),
        ("dock p010", dock(input_format="nv12", nv12_shift=8, dock=all6),
         [make_nv12(h, w, 210 + i, 10, True) for i in range(2)], "nv12",
         ("K1", "K2", "K3", "K5"), "K2"),
        ("dock rgba roi_rect", dock(dock=all6, roi_rect=roi,
                                    histogram=HistogramConfig(components=Components.YUV)),
         rgba, "rgba", ("K1", "K3", "K6", "K8"), "K6"),
        ("dock full-res overlays", dock(dock=all6, overlays_on_capture=False),
         rgba, "rgba", ("K1", "K2", "K3"), "K2"),
        ("dock vectorscope only", dock(dock=vs_only),
         rgba, "rgba", ("K1", "K3", "K7"), "K2"),
        ("full_step nv12", lambda d: make_full_step(h, w, scale=2, input_format="nv12",
                                                    device=d),
         [make_nv12(h, w, 220)], "nv12", ("K1", "K2", "K4"), "K2"),
    ]


def phase_dock_paths(device, **kw) -> dict:
    """Every dock path; returns {path: its counts by kernel id}."""
    return {name: run_path(name, build, frames, fmt, device, needs, both_as)
            for name, build, frames, fmt, needs, both_as in dock_paths(**kw)}


def phase_golden(device, h=270, w=480) -> None:
    """One small frame through the step on ``device`` vs the golden model."""
    from obs_color_monitor_tpu_torch import (
        Components, FocusPeakingConfig, frame_from_numpy, golden, make_full_step)

    fp_cfg = FocusPeakingConfig()
    f = make_frame(h, w, "random", 7)
    out = make_full_step(h, w, scale=2, input_format="packed", device=device)(
        frame_from_numpy(f.view(np.uint32)[..., 0], "packed", device), 2.5
    ).to_numpy()
    ds = golden.downscale(f, 2)
    yuv = golden.rgb_to_yuv_u8(ds, 2)
    want = {
        "vs_counts": golden.vectorscope_counts(yuv),
        "wv_counts": golden.waveform_counts(ds, yuv, Components.RGB),
        "hi_counts": golden.histogram_counts(ds, yuv, Components.RGB),
        "zebra": np.moveaxis(golden.zebra(f, 0.75, 1.0, 2.5, 2), -1, 0),
        "falsecolor": np.moveaxis(golden.falsecolor(f, 2), -1, 0),
        "focuspeaking": np.moveaxis(
            golden.focus_peaking(f, fp_cfg.peaking_threshold, fp_cfg.peaking_rgba), -1, 0),
    }
    for k, v in want.items():
        if not np.array_equal(out[k], v):
            raise AssertionError(f"golden check: {k} differs at {w}x{h}")
    print(f"golden: {w}x{h} frame: {', '.join(want)} equal to the golden model", flush=True)


def time_ms(fns: dict, reps=TIMING_REPS, inner=10, warmup=3) -> dict:
    """ms per call of each function in ``fns``: CUDA events around
    ``inner`` back-to-back calls, divided by ``inner``; the median of
    ``reps`` such runs.  The functions take turns in every rep, so a drift
    of the card or the host falls on all of them alike."""
    import torch

    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / inner)
    return {k: statistics.median(v) for k, v in times.items()}


def bincount_index(u, v, data, mask, need_vs=True, need_wv=True):
    """The input of the one ``torch.bincount`` call that gives K2's counts
    in the mode asked, and its ``minlength``: the vectorscope's bins
    ``v * 256 + u`` first, then the waveform's ``(c * 256 + value) * w +
    col``; mask-0 pixels go to one spare bin past the waveform's.  Built
    once, before any timing, as K2's plain version builds its own."""
    import torch

    ref = u if need_vs else data
    c, w = 3, ref.shape[-1]
    spare = (65536 if need_vs else 0) + (c * 256 * w if need_wv else 0)
    parts = []
    if need_vs:
        parts.append((v.to(torch.int64) * 256 + u).reshape(-1))
    if need_wv:
        wv = ((torch.arange(c, device=data.device).view(c, 1, 1) * 256 + data.to(torch.int64))
              * w + torch.arange(w, device=data.device))
        if mask is not None:
            wv = torch.where(mask[None] != 0, wv, spare - 65536 * need_vs)
        parts.append(65536 * need_vs + wv.reshape(-1))
    return torch.cat(parts), spare + 1


def library_counts(u, v, data, mask, need_vs=True, need_wv=True, rect=None):
    """``(fn, check)``: ``fn`` times the one bincount call; ``check`` raises
    unless its bins equal K2's counts in the same mode.  With a dynamic
    ``rect`` every pixel keeps its own bin and the call is weighted: 1
    inside the rect (and, for the waveform, where the mask is set), 0
    elsewhere, so the pixels outside add to no bin of their own."""
    import torch

    from obs_color_monitor_tpu_torch.ops import convert as cv
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    if rect is None:
        idx, n = bincount_index(u, v, data, mask, need_vs, need_wv)
        fn = lambda: torch.bincount(idx, minlength=n)
    else:
        h, w = (u if need_vs else data).shape[-2:]
        inside = cv.rect_mask(cv.clamp_rect(rect, w, h), h, w)
        idx, n = bincount_index(u, v, data, None, need_vs, need_wv)
        keep = [inside.reshape(-1)] if need_vs else []
        if need_wv:
            wv_keep = inside if mask is None else inside & (mask != 0)
            keep.append(wv_keep.expand(3, h, w).reshape(-1))
        weights = torch.cat(keep).to(torch.float32)  # counts < 2**24 stay exact
        fn = lambda: torch.bincount(idx, weights=weights, minlength=n)

    def check(name):
        bins = fn().to(torch.int32)
        vs, wv = ss.vs_wv_counts(u, v, data, mask, need_vs=need_vs, need_wv=need_wv, rect=rect)
        got = []
        if need_vs:
            got.append(torch.equal(bins[:65536].view(256, 256), vs))
        if need_wv:
            got.append(torch.equal(bins[65536 * need_vs:n - 1].view(wv.shape), wv))
        if not all(got):
            raise AssertionError(f"{name}: torch.bincount differs from the kernel's counts")
        print(f"{name}: torch.bincount equals the kernel's counts", flush=True)

    return fn, check


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms the card could take to move ``nbytes`` and do
    ``ops`` 32-bit operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(device, card: str) -> tuple[dict, dict]:
    """ms per call of the steps, the kernels, their plain versions and the
    library calls, and each kernel's bound at the timed shapes."""
    import torch

    from obs_color_monitor_tpu_torch import DockConfig, make_dock_step, make_full_step
    from obs_color_monitor_tpu_torch.ops import convert as cv
    from obs_color_monitor_tpu_torch.ops import decode as dec
    from obs_color_monitor_tpu_torch.ops import fused_overlays as fo
    from obs_color_monitor_tpu_torch.ops import pipeline as pl
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    fns, bounds = {}, {}
    step = make_full_step(H4K, W4K, scale=2, input_format="packed", device=device)
    kw = dict(packed=True, cs=2, scale=2, **OV_ARGS)
    h, w = H4K // 2, W4K // 2
    for kind in ("random", "flat"):
        x = as_input(make_frame(H4K, W4K, kind, 3), True, device)
        inputs = pl.stats_inputs(*pl.frame_pass_reference(x, 1.0, **kw)[:2], False)
        library, check = library_counts(*inputs)
        check(f"K2 library {kind}")
        fns[f"step_{kind}"] = lambda x=x: step(x, 1.0)
        fns[f"k1_{kind}"] = lambda x=x: pl.frame_pass(x, 1.0, **kw)
        fns[f"k1_plain_{kind}"] = lambda x=x: pl.frame_pass_reference(x, 1.0, **kw)
        fns[f"k2_{kind}"] = lambda i=inputs: ss.vs_wv_counts(*i)
        fns[f"k2_plain_{kind}"] = lambda i=inputs: ss.vs_wv_counts_reference(*i)
        fns[f"k2_library_{kind}"] = library
    # K1: frame read, three full-res overlays and the scaled/YUV planes
    # written; ~60 ops per full-res pixel, ~30 per scaled one
    bounds["K1"] = bound(H4K * W4K * (4 + 12) + h * w * 7, H4K * W4K * 60 + h * w * 30)
    # K2: u, v, data and mask read once, both histograms written
    bounds["K2"] = bound(h * w * 6 + 65536 * 4 + 3 * 256 * w * 4, h * w * 10)

    dock_nv12 = make_dock_step(H4K, W4K, scale=2, input_format="nv12",
                               dock=DockConfig(show_focuspeaking=True), device=device)
    y, uv = to_device(make_nv12(H4K, W4K, 5), device)
    y16, uv16 = to_device(make_nv12(H4K, W4K, 6, 10, True), device)
    fns["dock_nv12"] = lambda: dock_nv12((y, uv), 1.0)
    fns["k4"] = lambda: dec.nv12_decode(y, uv, cs=2)
    fns["k4_plain"] = lambda: cv.nv12_packed_reference(y, uv, 2)
    fns["k5"] = lambda: dec.nv12_16_decode(y16, uv16, cs=2, shift=8)
    fns["k5_plain"] = lambda: cv.nv12_16_packed_reference(y16, uv16, 2, 8)
    bounds["K4"] = bound(H4K * W4K * (1 + 0.5 + 4), H4K * W4K * 25)
    bounds["K5"] = bound(H4K * W4K * (2 + 1 + 4), H4K * W4K * 35)
    # K3 at the dock's shapes: the scaled capture, packed output
    cap = pl.frame_pass_reference(cv.nv12_packed_reference(y, uv, 2), packed=True, cs=2,
                                  scale=2, with_overlays=False)[0]
    k3kw = dict(OV_ARGS, packed_out=True)
    fns["k3"] = lambda: fo.fused_overlays_planes(cap, 1.0, **k3kw)
    fns["k3_plain"] = lambda: fo.fused_overlays_reference(cap, 1.0, **k3kw)
    bounds["K3"] = bound(h * w * (4 + 12), h * w * 60)
    # and at full resolution (the dock with overlays_on_capture=False)
    full = as_input(make_frame(H4K, W4K, "random", 4), False, device)
    fns["k3_fullres"] = lambda: fo.fused_overlays_planes(full, 1.0, **k3kw)
    fns["k3_fullres_plain"] = lambda: fo.fused_overlays_reference(full, 1.0, **k3kw)
    bounds["K3 full-res"] = bound(H4K * W4K * (4 + 12), H4K * W4K * 60)
    # K6 / K8: the ROI run's crop, RGB family both counts and YUV waveform
    # alone; K7: the vectorscope-only dock's whole capture
    x = as_input(make_frame(H4K, W4K, "random", 300), True, device)
    ds, yuv, *_ = pl.frame_pass_reference(x, packed=True, cs=2, scale=2, with_overlays=False)
    x0, y0, x1, y1 = ROI
    ch, cw = y1 - y0, x1 - x0
    ds_c, yuv_c = ds[:, y0:y1, x0:x1].contiguous(), yuv[:, y0:y1, x0:x1].contiguous()
    k6_in, k8_in = pl.stats_inputs(ds_c, yuv_c, False), pl.stats_inputs(ds_c, yuv_c, True)
    k7_in = (yuv[1], yuv[2], None, None)
    library = {k: library_counts(*args, **kw) for k, args, kw in (
        ("k6", k6_in, {}), ("k7", k7_in, dict(need_wv=False)), ("k8", k8_in, dict(need_vs=False)))}
    for k, (fn, check) in library.items():
        check(f"{k.upper()} library")
        fns[f"{k}_library"] = fn
    fns["k6"] = lambda: ss.vs_wv_counts(*k6_in)
    fns["k6_plain"] = lambda: ss.vs_wv_counts_reference(*k6_in)
    fns["k7"] = lambda: ss.vs_wv_counts(*k7_in, need_wv=False)
    fns["k7_plain"] = lambda: ss.vs_wv_counts_reference(*k7_in, need_wv=False)
    fns["k8"] = lambda: ss.vs_wv_counts(*k8_in, need_vs=False)
    fns["k8_plain"] = lambda: ss.vs_wv_counts_reference(*k8_in, need_vs=False)
    bounds["K6"] = bound(ch * cw * 6 + 65536 * 4 + 3 * 256 * cw * 4, ch * cw * 10)
    bounds["K7"] = bound(h * w * 2 + 65536 * 4, h * w * 4)
    bounds["K8"] = bound(ch * cw * 3 + 3 * 256 * cw * 4, ch * cw * 6)
    # K9 at the ingest path's shape, a 4K planar frame at scale 2: the
    # frame read, the scaled planes and both counts written; ~40 ops per
    # scaled pixel for the 2x2 sums and the Q12 YUV, ~10 for the counts
    planar = as_input(make_frame(H4K, W4K, "random", 600), False, device)
    fns["k9"] = lambda: pl.fused_ingest_stats_scale2(planar, 2)
    fns["k9_plain"] = lambda: pl.fused_ingest_stats_reference(planar, 2, 2)
    k9_in = pl.stats_inputs(*pl.frame_pass_reference(planar, packed=False, cs=2, scale=2,
                                                     with_overlays=False)[:2], False)
    fns["k9_library"], check = library_counts(*k9_in)
    check("K9 library")
    bounds["K9"] = bound(H4K * W4K * 4 + h * w * 4 + 65536 * 4 + 3 * 256 * w * 4, h * w * 50)
    # the dynamic-ROI dock step, eager and as a CUDA graph replay, and K2 /
    # K3 in rect mode at its shapes (the 1920x1080 capture, the ROI rect)
    dyn = make_dock_step(H4K, W4K, scale=2, input_format="nv12", dynamic_roi=True,
                         dock=DockConfig(show_focuspeaking=True), device=device)
    roi_t = torch.tensor(ROI, dtype=torch.int32, device=device)
    graph, _ = capture_graph(dyn, (y, uv), roi_t)
    fns["dock_nv12_dynamic"] = lambda: dyn((y, uv), 1.0, roi_t)
    fns["dock_nv12_dynamic_graph"] = graph.replay
    k2r_in = pl.stats_inputs(*pl.frame_pass_reference(cv.nv12_packed_reference(y, uv, 2),
                                                      packed=True, cs=2, scale=2,
                                                      with_overlays=False)[:2], False)
    fns["k2_rect"] = lambda: ss.vs_wv_counts(*k2r_in, rect=roi_t)
    fns["k2_rect_plain"] = lambda: ss.vs_wv_counts_reference(*k2r_in, rect=roi_t)
    fns["k2_rect_library"], check = library_counts(*k2r_in, rect=roi_t)
    check("K2 rect library")
    fns["k3_rect"] = lambda: fo.fused_overlays_planes(cap, 1.0, rect=roi_t, **k3kw)
    fns["k3_rect_plain"] = lambda: fo.fused_overlays_reference(cap, 1.0, rect=roi_t, **k3kw)
    rect_px = (ROI[2] - ROI[0]) * (ROI[3] - ROI[1])
    bounds["K2 rect"] = bound(rect_px * 6 + 65536 * 4 + 3 * 256 * w * 4, rect_px * 10)
    bounds["K3 rect"] = bounds["K3"]
    t = time_ms(fns)
    for k, v in t.items():
        print(f"time {k}: {v:.4f} ms  [{card}]", flush=True)
    device_ms({k: fn for k, fn in fns.items() if k.startswith("k") and "plain" not in k}, card)
    for k, (ms, by) in sorted(bounds.items()):
        print(f"bound {k}: {ms:.4f} ms ({by})", flush=True)
    return t, bounds


def device_events(prof) -> list:
    """The device's own work in a profile: its kernels and copies.  A
    record_function span shows on the device timeline too, over kernels
    counted on their own, so it is left out."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fns: dict, card: str, calls: int = 20) -> dict:
    """Device time per call of each function: the sum of the kernels it
    launched under torch.profiler over ``calls`` calls.  Unlike the event
    times of :func:`time_ms`, this leaves out the host's issue time, which
    a wrapper around a short kernel does not hide."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for k, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in device_events(prof))
        out[k] = us / calls / 1000
        print(f"device time {k}: {out[k]:.4f} ms  [{card}]", flush=True)
    return out


def profile_window(step, frame, label: str, card: str, steps: int = 10) -> None:
    """Where a step's time goes: torch.profiler over ``steps`` steps; device
    time per kernel name and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step(frame, 1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(frame, i * 0.0667)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    per_name: dict[str, list] = {}
    for e in device_events(prof):
        rec = per_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    busy = sum(v[0] for v in per_name.values())
    if not per_name:
        print(f"profile {label}: the profiler recorded no device time", flush=True)
        return
    print(f"profile {label}: {steps} steps, host window {window_us / steps / 1000:.4f} ms/step, "
          f"device busy {busy / steps / 1000:.4f} ms/step "
          f"({100 * busy / window_us:.1f}% of the window), "
          f"{sum(v[1] for v in per_name.values()) // steps} device ops/step  [{card}]",
          flush=True)
    for name, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"profile {label}: {us / steps / 1000:.4f} ms/step  x{n // steps}  {name[:90]}",
              flush=True)


def phase_profile(device, card: str) -> None:
    import torch

    from obs_color_monitor_tpu_torch import DockConfig, make_dock_step, make_full_step
    from obs_color_monitor_tpu_torch.config import ROIConfig
    from obs_color_monitor_tpu_torch.models import Dock

    profile_window(make_full_step(H4K, W4K, scale=2, input_format="packed", device=device),
                   as_input(make_frame(H4K, W4K, "random", 3), True, device), "full_step",
                   card)
    profile_window(make_dock_step(H4K, W4K, scale=2, input_format="nv12",
                                  dock=DockConfig(show_focuspeaking=True), device=device),
                   to_device(make_nv12(H4K, W4K, 5), device), "dock_nv12", card)
    profile_window(make_dock_step(H4K, W4K, scale=2, input_format="nv12", nv12_shift=8,
                                  dock=DockConfig(show_focuspeaking=True), device=device),
                   to_device(make_nv12(H4K, W4K, 6, 10, True), device), "dock_p010", card)
    dyn = make_dock_step(H4K, W4K, scale=2, input_format="nv12", dynamic_roi=True,
                         dock=DockConfig(show_focuspeaking=True), device=device)
    roi_t = torch.tensor(ROI, dtype=torch.int32, device=device)
    nv12 = to_device(make_nv12(H4K, W4K, 5), device)
    profile_window(lambda f, tm: dyn(f, tm, roi_t), nv12, "dock_nv12_dynamic", card)
    # the streaming Dock in steady state: a push and a render per frame
    dock = Dock(DockConfig(show_focuspeaking=True), roi=ROIConfig(interleave=0), device=device)
    profile_window(lambda f, tm: (dock.push_nv12(*f), dock.render_async())[1], nv12,
                   "models.Dock nv12", card)


KERNELS = [  # id, wrapper, source, TPU kernel it replaces, timing key, library key
    ("K1", "frame_pass", "frame_pipeline.cu", "ops/pallas_pipeline.py:149", "k1_random", None),
    ("K2", "vs_wv_counts", "scope_stats.cu", "ops/pallas_stats.py:315", "k2_random",
     "k2_library_random"),
    ("K3", "fused_overlays_planes", "fused_overlays.cu", "ops/pallas_overlays.py:173", "k3",
     None),
    ("K4", "nv12_decode", "nv12_decode.cu", "ops/pallas_convert.py:60", "k4", None),
    ("K5", "nv12_16_decode", "nv12_decode.cu", "ops/pallas_convert.py:88", "k5", None),
    ("K6", "vs_wv_counts (both kernels, static-rect crop)", "scope_stats.cu",
     "ops/pallas_stats.py:254", "k6", "k6_library"),
    ("K7", "vs_wv_counts(need_wv=False)", "scope_stats.cu", "ops/pallas_stats.py:156", "k7",
     "k7_library"),
    ("K8", "vs_wv_counts(need_vs=False)", "scope_stats.cu", "ops/pallas_stats.py:198", "k8",
     "k8_library"),
    ("K9", "fused_ingest_stats_scale2 (K1's scale launch, then K2)", "frame_pipeline.cu",
     "ops/pallas_stats.py:419", "k9", "k9_library"),
]
# K9 runs the kernels of two sources; K2 and K3 also run with a dynamic rect
SOURCES = {"K9": ("frame_pipeline.cu", "scope_stats.cu")}
RECT_MODE = {"K2": ("k2_rect", "k2_rect_library"), "K3": ("k3_rect", None)}


def main() -> int:
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    device = torch.device("cuda", 0)

    from obs_color_monitor_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.build(verbose=True)  # prints ptxas' registers / spills per kernel
    _kernels.library()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    err: dict = {}
    phase_kernels(device, kernel_cases(), err)
    phase_decode(device, err)
    phase_overlays(device, err)
    phase_stats_modes(device, err)
    torch.cuda.synchronize()
    phase_rect_kernels(device, err)
    phase_ingest(device, err)
    torch.cuda.synchronize()
    by_path = {**phase_main_path(device), **phase_dock_paths(device),
               **phase_ingest_path(device), **phase_dynamic_dock(device),
               **phase_stream_dock(device)}
    launches: dict = {}
    for counts in by_path.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    phase_golden(device)
    t, bounds = phase_timing(device, card)
    phase_profile(device, card)
    loaded = sorted(m for m in sys.modules if m in ("jax", "obs_color_monitor_tpu")
                    or m.startswith(("jax.", "obs_color_monitor_tpu.")))
    if loaded:
        raise AssertionError(f"the port loaded {loaded}")

    kernels = []
    csrc = "obs_color_monitor_tpu_torch/ops/csrc/"
    for kid, wrapper, src, tpu, tkey, lkey in KERNELS:
        if launches.get(kid, 0) < 1:
            raise AssertionError(f"{kid} was not launched on any main path: {launches}")
        entry = {
            "name": f"{wrapper} ({kid})", "route": "cuda",
            "source": csrc + src,
            "replaces": f"obs_color_monitor_tpu/{tpu}",
            "launches": launches[kid],
            "launches_by_path": {p: c[kid] for p, c in by_path.items() if c.get(kid)},
            "max_abs_err": err[kid],
            "ms": t[tkey], "plain_ms": t[tkey.replace("_random", "") + "_plain"
                                         + ("_random" if tkey.endswith("_random") else "")],
            "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1],
            "library_ms": t[lkey] if lkey else None,
        }
        if kid in SOURCES:
            entry["sources"] = [csrc + f for f in SOURCES[kid]]
        if kid in RECT_MODE:
            rkey, rlib = RECT_MODE[kid]
            entry.update({
                "rect_launches": launches[f"{kid} rect"],
                "rect_ms": t[rkey], "rect_plain_ms": t[rkey + "_plain"],
                "rect_bound_ms": bounds[f"{kid} rect"][0],
                "rect_library_ms": t[rlib] if rlib else None,
            })
        kernels.append(entry)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
