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
   packed output, with and without a rect, on planes whose width is a
   multiple of 4 but not of 16, or not of 4, and on planes whose base is
   not 16-byte aligned, with all three outputs and each alone, in every
   form also with a rect tensor; K2's vectorscope alone (K7),
   waveform alone (K8) and both (K6) on cropped planes; K2 in its three
   modes and K3 with a dynamic rect (a (4,) int32 tensor on the card) at
   1920x1080 and odd shapes, over rects inside, full, one pixel, empty,
   touching each edge, oversized and reversed; K2 on planes whose starts
   are not 16-byte aligned (slices of one buffer), on a crop whose width is
   not a multiple of 16 and on frames with fewer rows than a waveform
   cluster has blocks; K9 (the fused ingest statistics) at scale 2 on
   3840x2160 and scale 1 on 1920x1080 and odd shapes, and one 270x480 case
   against the golden model;
4. the main paths, each on the card and on the CPU, every output field
   equal, the launch counters set to 0 just before each path and read just
   after it (every kernel of the path must have launched):
   ``make_full_step(2160, 3840, scale=2, input_format="packed")``;
   ``make_dock_step(2160, 3840, scale=2, input_format="nv12",
   dock=DockConfig(show_focuspeaking=True))`` on NV12 frames and its P010
   form; rgba with a static ROI, full-resolution overlays, a
   vectorscope-only dock and ``make_full_step(input_format="nv12")``;
   ``fused_ingest_stats_scale2`` on 4K planar frames; the full step with a
   logscale histogram; the dynamic-ROI dock step (``dynamic_roi=True``) over
   a 6-rect drag, the same launches for every rect, equal at the ROI to the
   static ``roi_rect`` step, its captured graph replayed for more rects
   equal to ``step.eager``; the streaming ``models.Dock`` on 6 4K NV12
   frames with a move-drag on its ROI band, against a CPU Dock fed the
   same frames and mouse events; the captured steps (the full step, the
   static and dynamic dock steps, the settled Dock) at tm = 1.0 and 4.0,
   each replay equal to ``step.eager`` and to the CPU, the zebra differing
   between the clocks and an earlier result unchanged by a later call; the
   same captured steps fed host arrays as the JAX package's callers pass
   them (a numpy u32 4K packed frame with an ``np.float32`` clock through
   the full step, numpy NV12 and P010 pairs through the dock step with
   focus peaking, a numpy int32 rect and a tuple of ``np.int64`` through
   the dynamic dock step, a numpy (2, H, W) batch with numpy clocks
   through the batched step), each output equal byte for byte to the
   tensor call's, the same launches, no second graph, and the host-fed
   replay, the tensor-fed replay and the host-to-device copy alone timed
   by CUDA events; the overlay scopes' filter flavour ``apply(frame)`` on an interleaved 4K
   frame (Zebra, FalseColor plain, with a LUT and with its key beside the
   image, FocusPeaking at two thresholds) equal to the CPU, K3 once a call
   but for the LUT; ``ops.fused.analyze`` with the JAX package's keywords
   (``keep_rgba``, ``tm`` as a float and a 0-d tensor, ``is_packed``,
   ``backend``) at 4K scale 2 on the packed view and RGBA for the needs of
   K6, K7 and K8, each call equal to the default call with its K1 and K2
   launches, ``backend="xla"`` refused on the card and equal on the CPU;
   the batched step (``make_batched_step``) at B = 2 and 4 on 4K packed, B = 4
   on 1080p and B = 2 on 4K NV12 frames, each frame equal to the eager
   full step, one frame to the CPU, with one K1, K2 and K4 launch per
   batch; one 270x480 frame against the golden model.  The steps run as
   their users call them: on the card each is a CUDA graph replay, whose
   launches the wrappers' counts book per replay.  On every path K1, K2
   and K3 must also have taken their fast forms (16-byte loads, cp.async
   stages) on every call (the ``K1 vec`` / ``K2 vec`` / ``K3 vec``
   counts), and the streaming Dock must launch K3 exactly once per frame,
   settled or moving; then the mesh layer (``obs_color_monitor_tpu_torch.
   parallel``) under a world-size-1 NCCL group that ``make_mesh`` starts
   (destroyed after), each path a replay of its captured step (one graph
   per step, the all-reduce inside): ``batch_analyze`` on B = 2 4K frames
   in two orders, ``make_batched_step(mesh=)`` at B = 2 packed,
   ``spatial_analyze`` on two 4K frames and ``spatial_pipeline`` on two
   frames at tm 1.0 and 4.0, in both component families, each with one K1
   and one K2 launch and no K3, every output equal to its step's eager body,
   to the same calls under a gloo group on the CPU and to the unsharded port
   (``ops/fused.analyze``, the batched step without a mesh, the plain
   overlays); the overlay pieces of 2 and 4 ranks emulated in one process
   (K1 per block with its clock, K3 on the halo rows) equal to the whole
   frame's; each path's replay and eager times by CUDA events and the
   device busy share of each (torch.profiler), the unsharded analysis and
   the all-reduce alone (12,058,624 bytes of int32 counts a 4K frame);
5. timing with CUDA events (warm-up, then the median of 25 runs of 10
   back-to-back calls): each step eagerly (``step.eager``) and as its
   graph replay (input copies and output copies included), per frame: the
   4K full step, the 4K NV12 dock step, its dynamic-ROI form, the settled
   Dock and the batched step at B = 1, 2, 4; each kernel beside its plain
   version and, where one exists, the one PyTorch call that computes the
   same function (K2 and K3 also in rect mode, K2 also on a flat frame, K6
   also on a whole 4K frame at scale 1 (the mesh paths' shape), K1
   as its overlay+scale pass and its scale-only pass, K3 also with one
   output and with a cold L2, K1, K2, K4 and K5 also batched, each with
   its bound); then each kernel's device time alone, from torch.profiler:
   the sum of its kernels' durations and its span (first start to last
   end: K2's two counts overlap);
6. torch.profiler windows over 10 calls of each step, eager and replayed:
   device time per kernel and the device's busy share of the window;
7. the host pipeline (``obs_color_monitor_tpu_torch.pipeline`` and the
   CLI) at 3840x2160 NV12, stats at target_scale=2, the new-dock panel
   with focus peaking: a driver-fed ``models.Dock`` (24 frames, a flush
   after each) with every panel equal to a directly driven Dock on the card
   and the last one, with the published statistics, to a CPU Dock, one
   settled graph and no hub fan-out in steady state, and its P010 form;
   ``python -m obs_color_monitor_tpu_torch`` in process on a 4K ``.nv12``
   and ``.p010`` file (``dock``, ``--one-program``, ``scope vectorscope``
   and ``waveform``, ``--out-video``, ``--live`` with one image fetched
   over HTTP, ``info``), each PNG equal to the directly driven result
   (step 4's rules for the launch counts apply to each), and the dock with
   focus peaking and the vectorscope on a 4-frame file; then the installed
   console script: the package laid out as its wheel installs it (``pip
   wheel`` + ``pip install --target``, or a copy of the wheel's files
   where the Python lacks pip or setuptools) outside the repository and
   made read-only, fresh processes with only the layout on ``PYTHONPATH``
   and a fresh ``XDG_CACHE_HOME`` that build the kernels into that cache
   (timed), run ``info``, the dock and the vectorscope, each PNG equal
   byte for byte to the in-process one, the layout unchanged and neither
   JAX nor the JAX package imported; after the timing,
   the driver soak: a fresh Dock fed while its worker captures, then
   unpaced and 60 fps windows, each plain and under torch.profiler: frames
   pushed / processed / dropped, the sink's frames per second, push-to-panel
   latency, the device busy share and where the producer's time goes.

Then the total wall time, one JSON line with the per-kernel results, the
card line, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
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


ANALYZE_FIELDS = ("yuv_planes", "vs_counts", "wv_rgb", "wv_yuv", "hi_rgb", "hi_yuv", "planes")
ANALYZE_NEEDS = (  # the K2 mode each set of needs runs, as the kernel line books it
    ("K6", dict(need_vs=True, need_wv_rgb=True, need_hi_yuv=True)),  # then the YUV waveform
    ("K7", dict(need_vs=True)),
    ("K8", dict(need_wv_rgb=True, need_hi_rgb=True)),
)


def same_analysis(what: str, got, want) -> None:
    """Raise unless two ``AnalysisResult``s hold the same fields (None in
    the same places), each equal (tensors on any device)."""
    import torch

    for k in ANALYZE_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if (a is None) != (b is None) or (
                a is not None and (a.shape != b.shape or not torch.equal(a.cpu(), b.cpu()))):
            raise AssertionError(f"{what}: field {k} differs")


def phase_analyze_keywords(device, h=H4K, w=W4K) -> dict:
    """``ops.fused.analyze`` with the JAX package's keywords, at 4K scale 2
    on the packed view and on RGBA, for the needs of K6 (both counts, then
    the YUV waveform alone), K7 (the vectorscope alone) and K8 (the
    waveform alone): ``keep_rgba`` True and False, ``tm`` 0.0 and 4.0 as a
    float and as a 0-d tensor, ``is_packed=True`` (the packed view) and
    ``backend="pallas"``; and the host array itself, without ``backend``
    and with ``backend=default_backend()``.  Each call's fields equal the
    default call's (``planes`` None without ``keep_rgba``), with the
    default call's K1 and K2 launches, a host array's on the card;
    ``backend="xla"`` on a CUDA tensor raises ValueError; the host array
    with ``backend="xla"`` runs on the CPU, equal to the card.  Returns the
    default calls' counts by path."""
    import torch

    from obs_color_monitor_tpu_torch.ops.fused import analyze, default_backend

    f = make_frame(h, w, "random", 4100)
    forms = {"packed": f.view(np.int32)[..., 0], "rgba": f}
    route = "pallas" if device.type == "cuda" else "xla"

    def counted(call):
        """The call's result and its K1 and K2 launches (K2's pair as
        ``both``, its kernels alone as K7 / K8)."""
        if device.type == "cuda":
            torch.cuda.synchronize()
        reset_counts()
        out = call()
        return out, {k: v for k, v in read_counts().items() if k in ("K1", "both", "K7", "K8")}

    by_path = {}
    for fmt, host in forms.items():
        x = torch.from_numpy(np.ascontiguousarray(host)).to(device)
        for mode, needs in ANALYZE_NEEDS:
            kw = dict(cs=2, scale=2, **needs)
            name = f"analyze {fmt} {mode}"
            reset_counts()
            base, k12 = counted(lambda: analyze(x, **kw))
            by_path[name] = path_counts(name, read_counts(), ("K1", mode), device, both_as="K6")
            variants = [("keep_rgba=True", dict(keep_rgba=True)),
                        ("keep_rgba=False", dict(keep_rgba=False)),
                        ("tm=0.0", dict(tm=0.0)), ("tm=4.0", dict(tm=4.0)),
                        ("tm=tensor(0.0)", dict(tm=torch.zeros((), device=device))),
                        ("tm=tensor(4.0)", dict(tm=torch.full((), 4.0, device=device))),
                        (f"backend={route!r}", dict(backend=route))]
            if fmt == "packed":
                variants.append(("is_packed=True", dict(is_packed=True)))
            for label, extra in variants:
                got, c = counted(lambda: analyze(x, **kw, **extra))
                if c != k12:
                    raise AssertionError(f"{name} {label}: launches {c}, the default call's "
                                         f"{k12}")
                want = base._replace(planes=None) if extra.get("keep_rgba") is False else base
                same_analysis(f"{name} {label}", got, want)
            if default_backend() == route:  # a host array goes to the default device
                for label, extra in (("host array", {}),
                                     ("host array backend=default_backend()",
                                      dict(backend=default_backend()))):
                    got, c = counted(lambda: analyze(host, **kw, **extra))
                    if c != k12 or got.planes.device.type != device.type:
                        raise AssertionError(f"{name} {label}: launches {c} on "
                                             f"{got.planes.device}, the default call's {k12} "
                                             f"on {device}")
                    same_analysis(f"{name} {label}", got, base)
                    variants.append((label, extra))
            if device.type == "cuda":
                try:
                    analyze(x, backend="xla", **kw)
                except ValueError as e:
                    print(f"{name} backend='xla' on the card: ValueError ({e})", flush=True)
                else:
                    raise AssertionError(f"{name}: backend='xla' ran on a CUDA tensor")
            cpu = analyze(host, backend="xla", **kw)
            if cpu.planes.device.type != "cpu":
                raise AssertionError(f"{name}: backend='xla' ran on {cpu.planes.device}")
            same_analysis(f"{name} CPU backend='xla'", cpu, base)
            print(f"{name}: {len(variants)} keyword calls equal to the default call with its "
                  f"launches {k12}; the CPU's backend='xla' call equal",
                  flush=True)
    return by_path


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
    import torch

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
    # the public route, nv12_to_packed: the uint32 view (as JAX's) of one
    # K4 / K5 launch
    for kid, wrapper, shift, bits in (("K4", dec.nv12_decode, 0, 8),
                                      ("K5", dec.nv12_16_decode, 8, 10)):
        y, uv = to_device(make_nv12(H4K, W4K, 77, bits, bool(shift)), device)
        n = wrapper.launches
        got = cv.nv12_to_packed(y, uv, cs=2, shift=shift)
        if got.dtype != torch.uint32 or wrapper.launches - n != (device.type == "cuda"):
            raise AssertionError(f"nv12_to_packed: {got.dtype}, {wrapper.launches - n} "
                                 f"{kid} launches")
        ref = (cv.nv12_16_packed_reference(y, uv, 2, shift) if shift
               else cv.nv12_packed_reference(y, uv, 2))
        check_equal(kid, "nv12_to_packed 4K (uint32 view)", cv.as_packed(got), ref, err)


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


def overlay_form_cases(device):
    """K3 inputs in each of its forms: (case, planes).  Widths that are a
    multiple of 16 (the 16-byte copies), of 4 but not 16 (plain loads, word
    stores), and of neither (byte stores); and contiguous (4, H, W) views of
    one buffer at storage offsets 1 and 5, whose base is not 16-byte
    aligned."""
    import torch

    rng = np.random.default_rng(41)
    for h, w in ((68, 144), (68, 132), (70, 130), (33, 17)):
        buf = torch.from_numpy(rng.integers(0, 256, 4 * h * w + 16, np.uint8)).to(device)
        buf[3 * h * w + 1:4 * h * w + 5:7] = 0  # some alpha-0 pixels
        for off in (0, 1, 5):
            if off and w % 16:
                continue
            yield f"{h}x{w} at +{off}", buf[off:off + 4 * h * w].view(4, h, w)


OUTPUT_SETS = ((True, True, True), (True, False, False), (False, True, False),
               (False, False, True))


def phase_overlays(device, err: dict) -> None:
    """K3 vs its plain version: :func:`overlay_cases`, then every form of
    :func:`overlay_form_cases` with each output alone and all three, planar
    and packed, without and with a rect tensor."""
    import torch

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
    for case, x in overlay_form_cases(device):
        h, w = x.shape[1:]
        for r in (None, (w // 5, h // 4, w - 3, h - 2), (0, 0, w // 2, h)):
            rect = None if r is None else torch.tensor(r, dtype=torch.int32, device=device)
            for outputs in OUTPUT_SETS:
                for packed_out in (False, True):
                    kw = dict(OV_ARGS, rect=rect, packed_out=packed_out, outputs=outputs)
                    check_equal("K3", f"{case} rect={r} packed_out={packed_out} "
                                f"outputs={outputs}", fo.fused_overlays_planes(x, 2.9, **kw),
                                fo.fused_overlays_reference(x, 2.9, **kw), err)


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


def alignment_cases(device):
    """K2 inputs that are not 16-byte aligned or are small: (case, (u, v,
    data, mask)).  Slices of one buffer at offsets 1, 3, 5, 8 and 16 (as
    stats_inputs slices yuv[1] and yuv[2] out of one allocation); a
    1441-wide crop of a 1080-row capture; and frames with fewer rows than a
    waveform cluster has blocks."""
    import torch

    from obs_color_monitor_tpu_torch.ops import pipeline as pl

    rng = np.random.default_rng(31)
    h, w = 64, 96
    buf = torch.from_numpy(rng.integers(0, 256, 5 * h * w + 64, np.uint8)).to(device)
    for off in (1, 3, 5, 8, 16):
        yield f"slices at +{off}", (
            buf[off + h * w:off + 2 * h * w].view(h, w),
            buf[off + 2 * h * w + 5:off + 3 * h * w + 5].view(h, w),
            buf[off:off + 3 * h * w].view(3, h, w),
            buf[off + 3 * h * w + 2:off + 4 * h * w + 2].view(h, w))
    for ch, cw in ((1080, 1441), (1, 1), (3, 2000), (5, 40), (7, 16)):
        x = as_input(make_frame(ch, cw, "random", ch + cw), True, device)
        ds, yuv, *_ = pl.frame_pass_reference(x, packed=True, cs=2, scale=1,
                                              with_overlays=False)
        for fam in (False, True):
            yield f"{ch}x{cw} {'yuv' if fam else 'rgb'}", pl.stats_inputs(ds, yuv, fam)


def phase_stats_alignment(device, err: dict) -> None:
    """K2 in each mode vs its plain version on :func:`alignment_cases`."""
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    for case, inputs in alignment_cases(device):
        for kernel, need_vs, need_wv in (("K2", True, True), ("K7", True, False),
                                         ("K8", False, True)):
            kw = dict(need_vs=need_vs, need_wv=need_wv)
            check_equal(kernel, case, ss.vs_wv_counts(*inputs, **kw),
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
        "K1 vec": pipeline.frame_pass.launches_vec,
        "K2 vec": vs.launches_vec,
        "both": vs.launches - vs.launches_vs_only - vs.launches_wv_only,
        "K7": vs.launches_vs_only,
        "K8": vs.launches_wv_only,
        "K2 rect": vs.launches_rect,
        "K3": fused_overlays.fused_overlays_planes.launches,
        "K3 vec": fused_overlays.fused_overlays_planes.launches_vec,
        "K3 rect": fused_overlays.fused_overlays_planes.launches_rect,
        "K4": decode.nv12_decode.launches,
        "K5": decode.nv12_16_decode.launches,
    }


def reset_counts() -> None:
    from obs_color_monitor_tpu_torch.ops import decode, fused_overlays, pipeline, scope_stats

    vs = scope_stats.vs_wv_counts
    pipeline.frame_pass.launches = pipeline.frame_pass.launches_vec = 0
    vs.launches = vs.launches_vs_only = vs.launches_wv_only = vs.launches_rect = 0
    vs.launches_vec = 0
    fo = fused_overlays.fused_overlays_planes
    fo.launches = fo.launches_rect = fo.launches_vec = 0
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
    k2 = counts[both_as] + counts["K7"] + counts["K8"]
    fast = (counts["K1 vec"], counts["K2 vec"], counts["K3 vec"])
    if device.type == "cuda" and fast != (counts["K1"], k2, counts["K3"]):
        raise AssertionError(f"path {name}: K1, K2 or K3 left its fast form: {counts}")
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
    counts["K9 vec"] = counts["K1 vec"] + counts["K2 vec"]
    for i, a in enumerate(host):
        ref = [t.numpy() for t in pl.fused_ingest_stats_scale2(torch.from_numpy(a), 2)]
        compare_fields(f"path {name} frame {i}", dict(zip("vwd", outs[i])), dict(zip("vwd", ref)))
    print(f"path {name}: vs, wv and ds equal to the CPU on {frames} frames", flush=True)
    return {name: counts}


def drag_rects(roi, n: int, step: tuple) -> list:
    """``n`` positions of a rect dragged by ``step`` per frame."""
    return [(roi[0] + k * step[0], roi[1] + k * step[1], roi[2] + k * step[0],
             roi[3] + k * step[1]) for k in range(n)]


def phase_dynamic_dock(device, h=H4K, w=W4K, roi=ROI, frames=DRAG_FRAMES) -> dict:
    """The dynamic-ROI dock step over a drag: each frame equal to the CPU
    step at its rect, the same launches for every rect, equal at the ROI to
    the static roi_rect step; on a card the step is its CUDA graph, one
    graph for every rect, and its replays for the later rects (and the edge
    rects, also given as host ints) equal the eager step."""
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
        for r in graph_rects:
            t = torch.tensor(r, dtype=torch.int32, device=device)
            eager = step.eager(dev[0], 1.0, t).to_numpy()
            for rect in (t, r):  # a rect tensor, or host ints written into the graph's buffer
                compare_fields(f"path {name} graph replay rect {r}",
                               step(dev[0], 1.0, rect).to_numpy(), eager)
        if step.graphs != 1:
            raise AssertionError(f"path {name}: {step.graphs} graphs for one frame shape")
        print(f"path {name}: one CUDA graph, replayed for {len(graph_rects)} rects (as tensors "
              "and as host ints), equals the eager step at each", flush=True)
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
        panels, k3 = [], []
        for d in docks:
            events(d, i)
            before = read_counts()["K3"]
            d.push_nv12(y, uv)
            panels.append(d.render())
            k3.append(read_counts()["K3"] - before)
        card, cpu = docks
        # the card's Dock computes its overlays in one K3 launch per frame,
        # settled (the shared launch) or moving (the dynamic step's); the
        # CPU Dock runs the plain version, uncounted
        if device.type == "cuda" and k3[0] != 1:
            raise AssertionError(f"path {name} frame {i}: {k3[0]} K3 launches, expected 1")
        if not np.array_equal(*panels):
            raise AssertionError(f"path {name} frame {i}: the panel differs from the CPU Dock's")
        if not (np.array_equal(card.vectorscope._read().cpu().numpy(),
                               cpu.vectorscope._read().numpy())
                and np.array_equal(card.histogram.counts(), cpu.histogram.counts())):
            raise AssertionError(f"path {name} frame {i}: published statistics differ")
        print(f"path {name} frame {i}: rect {card.hub.config.resolve_rect(w // 2, h // 2)}, "
              f"dynamic {card.hub.last_surface.dynamic_rect is not None}, {k3[0]} K3 launch: "
              "panel, vectorscope and histogram equal to the CPU Dock's", flush=True)
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
    logscale = HistogramConfig(logscale=True)
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
        # float32 log levels on the card against the CPU's
        ("full_step logscale", lambda d: make_full_step(h, w, scale=2, histogram=logscale,
                                                        device=d),
         rgba, "rgba", ("K1", "K2"), "K2"),
    ]


def phase_dock_paths(device, **kw) -> dict:
    """Every dock path; returns {path: its counts by kernel id}."""
    return {name: run_path(name, build, frames, fmt, device, needs, both_as)
            for name, build, frames, fmt, needs, both_as in dock_paths(**kw)}


CLOCKS = (1.0, 4.0)  # zebra phases 3 of 6 apart: every stripe flips


def host_fields(out) -> dict:
    """The set fields of a step's output as host arrays."""
    return {k: v.cpu().numpy() for k, v in out._asdict().items() if v is not None}


def check_clocks(name: str, outs: list, field: str) -> None:
    """Raise unless ``field`` differs between the two clocks' outputs (a
    graph that froze the clock would replay the first one's zebra)."""
    if np.array_equal(outs[0][field], outs[1][field]):
        raise AssertionError(f"{name}: {field} is the same at tm = {CLOCKS}: a frozen clock")


def phase_captured(device, h=H4K, w=W4K, roi=ROI) -> dict:
    """Each captured step at tm = 1.0 and 4.0: the 4K packed full step, the
    4K NV12 dock step, its dynamic-ROI form and the settled streaming
    ``models.Dock``.  On a card each replay equals ``step.eager`` on the
    same inputs there and the same step on the CPU; the zebra output (the
    full step's plane, the docks' panels) differs between the clocks; a
    result returned earlier is unchanged after a later call.  The counts
    are read around the replays."""
    import torch

    from obs_color_monitor_tpu_torch import (
        DockConfig, ROIConfig, frame_from_numpy, make_dock_step, make_full_step)
    from obs_color_monitor_tpu_torch.models import Dock

    all6 = DockConfig(show_focuspeaking=True)
    sw, sh = w // 2, h // 2
    packed = make_frame(h, w, "random", 900).view(np.uint32)[..., 0]
    nv12 = make_nv12(h, w, 901)
    steps = [
        ("captured full_step packed", lambda d: make_full_step(
            h, w, scale=2, input_format="packed", device=d), packed, "packed", (),
         "zebra", ("K1", "K2")),
        ("captured dock nv12", lambda d: make_dock_step(
            h, w, scale=2, input_format="nv12", dock=all6, device=d), nv12, "nv12", (),
         "panel", ("K1", "K2", "K3", "K4")),
        ("captured dock nv12 dynamic_roi", lambda d: make_dock_step(
            h, w, scale=2, input_format="nv12", dock=all6, dynamic_roi=True, device=d), nv12,
         "nv12", (roi,), "panel", ("K1", "K2", "K3", "K4", "K2 rect", "K3 rect")),
    ]
    by_path = {}
    for name, build, host, fmt, extra, field, needs in steps:
        step, step_cpu = build(device), build("cpu")
        x = frame_from_numpy(host, fmt, device)
        x_cpu = frame_from_numpy(host, fmt, "cpu")
        dev_extra = tuple(torch.tensor(r, dtype=torch.int32, device=device) for r in extra)
        cpu_extra = tuple(torch.tensor(r, dtype=torch.int32) for r in extra)
        if device.type == "cuda":
            torch.cuda.synchronize()
        reset_counts()
        outs, first = [], None
        for tm in CLOCKS:
            out = step(x, tm, *dev_extra)
            first = first or out
            outs.append(host_fields(out))
        counts = path_counts(name, read_counts(), needs, device)
        for tm, got in zip(CLOCKS, outs):
            compare_fields(f"{name} tm {tm} vs the CPU", got,
                           host_fields(step_cpu(x_cpu, tm, *cpu_extra)))
            if device.type == "cuda":
                compare_fields(f"{name} tm {tm} vs step.eager", got,
                               host_fields(step.eager(x, tm, *dev_extra)))
        check_clocks(name, outs, field)
        step(x, 7.5, *dev_extra)
        compare_fields(f"{name}: the tm {CLOCKS[0]} result after a later call",
                       host_fields(first), outs[0])
        print(f"{name}: the replays equal step.eager and the CPU at tm {CLOCKS}, {field} "
              "differs between them, an earlier result is unchanged", flush=True)
        by_path[name] = counts

    # the settled Dock: frame 0 publishes through the hub, frame 1 renders
    # every scope (the waveform shows the frame before), frame 2 captures
    # the stream step; frames 3 and 4 replay it, at the two clocks (set
    # after each push, which ticks them)
    name = "captured models.Dock settled"
    docks = [Dock(all6, roi=ROIConfig(target_scale=2, interleave=0), device=d)
             for d in (device, "cpu")]
    warm = 3
    frames = [make_nv12(h, w, 910 + i) for i in range(warm + len(CLOCKS))]
    outs, first = [], None
    # the replays' launches, read around each render alone (the eager
    # comparison's launches are not the path's)
    total = dict.fromkeys(read_counts(), 0)
    for i, (y, uv) in enumerate(frames):
        panels = []
        for d in docks:
            d.push_nv12(y, uv)
            if i >= warm:
                d.zebra.tm = CLOCKS[i - warm]
            card = d is docks[0]
            eager = None
            if i >= warm and card and device.type == "cuda":
                p, wv = d._pending, d.waveform
                eager = d._settled.eager((p.y, p.uv), float(d.zebra.tm), wv._buf[wv._r_buf])[0]
            before = read_counts()
            panels.append(d.render_async())
            if card and i >= warm:
                counts_i = {k: v - before[k] for k, v in read_counts().items()}
                if device.type == "cuda" and (counts_i["K3"] != 1 or counts_i["K1"] != 1):
                    raise AssertionError(f"{name} frame {i}: {counts_i}")
                total = {k: v + counts_i[k] for k, v in total.items()}
            if eager is not None and not torch.equal(eager, panels[-1]):
                raise AssertionError(f"{name} frame {i}: the replay differs from its eager step")
        if not np.array_equal(panels[0].cpu().numpy(), panels[1].numpy()):
            raise AssertionError(f"{name} frame {i}: the panel differs from the CPU Dock's")
        if i >= warm:
            first = first if first is not None else panels[0]
            outs.append({"panel": panels[0].cpu().numpy()})
    counts = path_counts(name, total, ("K1", "K2", "K3", "K4"), device)
    if docks[0]._settled is None or (device.type == "cuda" and docks[0]._settled.graphs != 1):
        raise AssertionError(f"{name}: the settled route did not replay its graph")
    check_clocks(name, outs, "panel")
    if not np.array_equal(first.cpu().numpy(), outs[0]["panel"]):
        raise AssertionError(f"{name}: an earlier panel changed")
    print(f"{name}: the replays equal the eager stream step and the CPU Dock at tm {CLOCKS}, "
          "the panels differ between them, an earlier panel is unchanged", flush=True)
    by_path[name] = counts
    return by_path


def host_twin(a, device):
    """The tensor call's argument for a host argument: a frame or plane on
    ``device`` (a u32 frame as its int32 view), a clock as a Python float,
    a rect as an int32 tensor."""
    import torch

    if isinstance(a, tuple) and all(isinstance(v, np.ndarray) for v in a):
        return tuple(host_twin(v, device) for v in a)
    if isinstance(a, tuple):
        return torch.tensor([int(v) for v in a], dtype=torch.int32, device=device)
    if isinstance(a, np.ndarray) and a.ndim == 1 and a.dtype.kind == "i":
        return torch.tensor(a.tolist(), dtype=torch.int32, device=device)
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)
    return float(a)


def host_args_paths(h: int, w: int, roi) -> list:
    """(name, builder, calls, kernels) of each captured step fed host
    arrays; ``calls`` are the host argument tuples, in order, made to one
    step (the dynamic step takes its rect in two host forms)."""
    from obs_color_monitor_tpu_torch import (
        DockConfig, make_batched_step, make_dock_step, make_full_step)

    all6 = DockConfig(show_focuspeaking=True)
    packed = make_frame(h, w, "random", 1300).view(np.uint32)[..., 0]
    nv12, p010 = make_nv12(h, w, 1301), make_nv12(h, w, 1302, 10, True)
    batch = np.stack([make_frame(h, w, "random", 1303 + i).view(np.uint32)[..., 0]
                      for i in range(2)])
    clock = np.float32(1.0)

    def dock(**kw):
        return lambda d: make_dock_step(h, w, scale=2, dock=all6, device=d, **kw)

    return [
        ("host full_step packed", lambda d: make_full_step(
            h, w, scale=2, input_format="packed", device=d), [(packed, clock)], ("K1", "K2")),
        ("host dock nv12", dock(input_format="nv12"), [(nv12, clock)],
         ("K1", "K2", "K3", "K4")),
        ("host dock p010", dock(input_format="nv12", nv12_shift=8), [(p010, clock)],
         ("K1", "K2", "K3", "K5")),
        ("host dock nv12 dynamic_roi", dock(input_format="nv12", dynamic_roi=True),
         [(nv12, clock, np.asarray(roi, np.int32)),
          (nv12, clock, tuple(np.int64(v) for v in roi))],
         ("K1", "K2", "K3", "K4", "K2 rect", "K3 rect")),
        ("host batched packed B=2", lambda d: make_batched_step(
            h, w, scale=2, input_format="packed", device=d),
         [(batch, np.asarray([0.0667, 1.3167], np.float32))], ("K1", "K2")),
    ]


def phase_host_args(device, card: str = "", h=H4K, w=W4K, roi=ROI) -> dict:
    """Each captured step fed host arrays (:func:`host_args_paths`): the
    step is captured with the tensor call's arguments, then every output
    of each host call equals the tensor call's byte for byte and lies on
    ``device``, each host call launches what the tensor call launches
    (K1-K5 as the path needs them, counts read around each call alone), and
    no host call captures a second graph.  On a card, CUDA events time the
    4K host-fed replay against the tensor-fed one and the host-to-device
    copy of the frame alone, for the full step and the NV12 dock step."""
    import torch

    by_path, steps = {}, {}
    paths = host_args_paths(h, w, roi)
    for name, build, calls, needs in paths:
        step = build(device)
        steps[name] = (step, calls[0])
        total = dict.fromkeys(read_counts(), 0)
        for host in calls:
            dev = tuple(host_twin(a, device) for a in host)
            step(*dev)  # the capture, from the tensor call
            graphs = step.graphs
            if device.type == "cuda":
                torch.cuda.synchronize()
            reset_counts()
            want = step(*dev)
            tensor_counts = read_counts()
            reset_counts()
            got = step(*host)
            counts = read_counts()
            if any(v.device.type != device.type for v in got if v is not None):
                raise AssertionError(f"{name}: a host call left {device}")
            compare_fields(f"{name} host call vs the tensor call", host_fields(got),
                           host_fields(want))
            if counts != tensor_counts:
                raise AssertionError(f"{name}: the host call launched {counts}, the tensor "
                                     f"call {tensor_counts}")
            if step.graphs != graphs or (device.type == "cuda" and graphs != 1):
                raise AssertionError(f"{name}: {step.graphs} graphs after the host call, "
                                     f"{graphs} before")
            total = {k: v + counts[k] for k, v in total.items()}
        by_path[name] = path_counts(name, total, needs, device)
        print(f"{name}: {len(calls)} host call(s) equal to the tensor call byte for byte, the "
              f"same launches, {step.graphs} graph(s)", flush=True)
    if device.type != "cuda":
        return by_path
    for name in ("host full_step packed", "host dock nv12"):
        step, host = steps[name]
        dev = tuple(host_twin(a, device) for a in host)
        frame = host[0] if isinstance(host[0], tuple) else (host[0],)
        planes = tuple(torch.from_numpy(p.view(np.int32) if p.dtype == np.uint32 else p)
                       for p in frame)
        bufs = tuple(torch.empty_like(p, device=device) for p in planes)
        t = time_ms({"host": lambda: step(*host), "tensor": lambda: step(*dev),
                     "h2d": lambda: [b.copy_(p) for b, p in zip(bufs, planes)]})
        nbytes = sum(p.numel() * p.element_size() for p in planes)
        print(f"host_args timing {name} {h}x{w}: ms per frame host-fed {t['host']!r}, "
              f"tensor-fed {t['tensor']!r}, H2D copy alone {t['h2d']!r} ({nbytes} bytes from "
              f"pageable memory), the copy's share of the host-fed frame "
              f"{t['h2d'] / t['host']!r}; {card}", flush=True)
    return by_path


def phase_scope_apply(device, h=H4K, w=W4K) -> dict:
    """The overlay scopes' filter flavour, ``apply(frame)``, on one
    interleaved 4K frame: Zebra after a tick, FalseColor plain, with a
    user LUT and with its key beside the image (a larger canvas), and
    FocusPeaking at two thresholds; each on the card equal to the same
    scope on the CPU, the K3 route (all but the LUT) launching K3 once a
    call.  Returns the counts by path."""
    import torch

    from obs_color_monitor_tpu_torch import FalseColorConfig, FocusPeakingConfig, ShowKey
    from obs_color_monitor_tpu_torch.models import FalseColor, FocusPeaking, Zebra

    f = make_frame(h, w, "random", 4000)
    f[h // 3: h // 2, :, :3] = np.maximum(f[h // 3: h // 2, :, :3], 215)  # the zebra's window
    x = torch.from_numpy(f).to(device)
    lut = np.random.default_rng(4001).integers(0, 256, (33, 4), np.uint8)
    cases = (
        ("Zebra", lambda d: Zebra(device=d)),
        ("FalseColor", lambda d: FalseColor(device=d)),
        ("FalseColor LUT", lambda d: FalseColor(FalseColorConfig(use_lut=True, lut=lut),
                                                device=d)),
        ("FalseColor key outside", lambda d: FalseColor(
            FalseColorConfig(show_key=ShowKey.OUTSIDE), device=d)),
        ("FocusPeaking 0.05", lambda d: FocusPeaking(device=d)),
        ("FocusPeaking 0.012", lambda d: FocusPeaking(
            FocusPeakingConfig(peaking_threshold=0.012), device=d)),
    )
    by_path = {}
    for name, make in cases:
        card, host = make(device), make("cpu")
        if isinstance(card, Zebra):
            card.tick(0.5)
            host.tick(0.5)
        k3 = 0 if name.endswith("LUT") else 1
        if device.type == "cuda":
            torch.cuda.synchronize()
        reset_counts()
        got = card.apply(x)
        counts = path_counts(f"scope apply {name}", read_counts(), ("K3",) * k3, device)
        if device.type == "cuda" and counts["K3"] != k3:
            raise AssertionError(f"scope apply {name}: {counts}, expected {k3} K3 launch")
        want = host.apply(f)
        if got.shape != want.shape or not torch.equal(got.cpu(), want):
            raise AssertionError(f"scope apply {name}: the card's frame differs from the CPU's")
        if torch.equal(want, torch.from_numpy(f)):
            raise AssertionError(f"scope apply {name}: the overlay changed nothing")
        print(f"scope apply {name}: {tuple(got.shape)} equal to the CPU", flush=True)
        by_path[f"scope apply {name}"] = counts
    return by_path


BATCH_CASES = (  # name, h, w, input format, B
    ("batched packed 4K B=2", H4K, W4K, "packed", 2),
    ("batched packed 4K B=4", H4K, W4K, "packed", 4),
    ("batched packed 1080p B=4", 1080, 1920, "packed", 4),
    ("batched nv12 4K B=2", H4K, W4K, "nv12", 2),
    ("batched p010 4K B=2", H4K, W4K, "p010", 2),
)


def step_format(fmt: str) -> dict:
    """The step keywords of a batch format ("p010": 10-bit MSB-aligned u16
    NV12 planes)."""
    if fmt == "p010":
        return dict(input_format="nv12", nv12_shift=8)
    return dict(input_format=fmt)


def batch_input(h, w, fmt, b, seed, device):
    """(host frames, the batch on ``device``, distinct clocks (b,))."""
    import torch

    if fmt in ("nv12", "p010"):
        host = [make_nv12(h, w, seed + i, *((10, True) if fmt == "p010" else ())) for i in range(b)]
        batch = tuple(torch.from_numpy(np.stack([f[k] for f in host])).to(device)
                      for k in range(2))
    else:
        host = [make_frame(h, w, "random", seed + i).view(np.uint32)[..., 0] for i in range(b)]
        batch = torch.from_numpy(np.stack(host).view(np.int32)).to(device)
    tms = torch.tensor([0.0667 + 1.25 * i for i in range(b)], dtype=torch.float32,
                       device=device)
    return host, batch, tms


def phase_batched(device, cases=BATCH_CASES) -> dict:
    """``make_batched_step`` at scale 2: each frame equal to the eager full
    step on that frame with its clock, the last frame equal to the CPU
    step, and one K1, one K2 and (NV12 / P010) one K4 / K5 launch per
    batch."""
    from obs_color_monitor_tpu_torch import frame_from_numpy, make_batched_step, make_full_step

    by_path = {}
    for n, (name, h, w, fmt, b) in enumerate(cases):
        kw = step_format(fmt)
        step = make_batched_step(h, w, scale=2, device=device, **kw)
        single = make_full_step(h, w, scale=2, device=device, **kw)
        host, batch, tms = batch_input(h, w, fmt, b, 1000 + 10 * n, device)
        reset_counts()
        out = host_fields(step(batch, tms))
        decode = {"nv12": ("K4",), "p010": ("K5",)}.get(fmt, ())
        counts = path_counts(name, read_counts(), ("K1", "K2") + decode, device)
        per_batch = {"K1": 1, "K2": 1, "K4": int(fmt == "nv12"), "K5": int(fmt == "p010")}
        if device.type == "cuda" and any(counts[k] != v for k, v in per_batch.items()):
            raise AssertionError(f"{name}: {counts}, expected one launch per batch {per_batch}")
        fmt = kw["input_format"]
        for i, f in enumerate(host):
            x = frame_from_numpy(f, fmt, device)
            want = host_fields((single.eager if device.type == "cuda" else single)(x, tms[i]))
            compare_fields(f"{name} frame {i} vs the full step", {k: v[i] for k, v in out.items()},
                           want)
        cpu = make_full_step(h, w, scale=2, device="cpu", **kw)
        compare_fields(f"{name} frame {b - 1} vs the CPU", {k: v[b - 1] for k, v in out.items()},
                       host_fields(cpu(frame_from_numpy(host[-1], fmt, "cpu"),
                                       tms[b - 1].cpu())))
        print(f"{name}: every frame equals the full step, the last the CPU; launches "
              f"K1={counts['K1']} K2={counts['K2']} K4={counts['K4']} K5={counts['K5']} for {b} "
              "frames", flush=True)
        by_path[name] = counts
    return by_path


MESH_B = 2  # the mesh phase's batch
MESH_OV = dict(th_low=0.75, th_high=1.0, peak_th=3062, peak_rgba=(255, 84, 0, 255))
MESH_COMPONENTS = ("rgb", "yuv")
MESH_PIPE_CALLS = ((0, 1.0), (0, 4.0), (1, 1.0), (1, 4.0))  # (frame, tm) of the pipeline


def mesh_inputs(device, h=H4K, w=W4K, b=MESH_B):
    """(the (b, h, w, 4) frames, the packed batch and its clocks) of the
    mesh phase on ``device``; frames 0 and 1 are the spatial paths' frames,
    and the batch paths also take the batch in reverse order."""
    import torch

    host = np.stack([make_frame(h, w, "random", 3000 + i) for i in range(b)])
    host[0, ::270, :, :3] = 255  # bright rows, some on the split rows of 2, 4 and 8 ranks
    host[1, 5::97, :, :3] = 250
    _, packed, tms = batch_input(h, w, "packed", b, 3100, device)
    return torch.from_numpy(host).to(device), packed, tms


def mesh_steps(pm, mb, mr) -> dict:
    """The cached device step of each mesh path the phase calls, by name."""
    steps = {"batch_analyze": pm._mesh_step("batch_analyze", mb, cs=2)}
    for comp in MESH_COMPONENTS:
        steps[f"spatial_analyze {comp}"] = pm._mesh_step("spatial_analyze", mr, cs=2,
                                                         components=comp)
        steps[f"spatial_pipeline {comp}"] = pm._mesh_step("spatial_pipeline", mr, cs=2,
                                                          components=comp, **MESH_OV)
    return steps


def mesh_calls(par, mb, mr, steps, frames, packed, tms, step) -> dict:
    """The mesh phase's calls, by path name: {name: (the call, the same
    call on its step's eager body)}; each returns its outputs."""
    calls = {}
    for i, x in enumerate((frames, frames.flip(0))):
        calls[f"mesh batch_analyze B=2 batch {i}"] = (
            lambda x=x: par.batch_analyze(x, mb, cs=2),
            lambda x=x: steps["batch_analyze"].eager(x))
    calls["mesh batched step B=2"] = (lambda: step(packed, tms)._asdict(),
                                      lambda: step.eager(packed, tms)._asdict())
    for comp in MESH_COMPONENTS:
        sa, sp = steps[f"spatial_analyze {comp}"], steps[f"spatial_pipeline {comp}"]
        for i in range(2):
            calls[f"mesh spatial_analyze {comp} frame {i}"] = (
                lambda comp=comp, i=i: par.spatial_analyze(frames[i], mr, cs=2, components=comp),
                lambda sa=sa, i=i: sa.eager(frames[i]))
        for i, tm in MESH_PIPE_CALLS:
            calls[f"mesh spatial_pipeline {comp} frame {i} tm {tm}"] = (
                lambda comp=comp, i=i, tm=tm: par.spatial_pipeline(
                    frames[i], mr, cs=2, tm=tm, components=comp, **MESH_OV),
                lambda sp=sp, i=i, tm=tm: sp.eager(frames[i], tm))
    return calls


def to_host(out) -> dict:
    """A call's outputs (a tuple or a dict of tensors) as host arrays."""
    items = out.items() if isinstance(out, dict) else enumerate(out)
    return {str(k): v.cpu().numpy() for k, v in items if v is not None}


def run_mesh(device, h, w, b, timing: bool = False, card: str = ""):
    """Every mesh call on ``device`` over a fresh world-size-1 group (NCCL
    on a card, gloo on the CPU, started by ``make_mesh``), each with its
    launch counts read around it alone.  On a card each path's call is a
    replay of its cached step's graph (the first call captures it): each
    must launch one K1, one K2 and no K3, equal its step's eager body on
    the same inputs, and each step must hold one graph at the end.  With
    ``timing``, the times.  The group is destroyed before returning.
    Returns (outputs by path, counts by path, times)."""
    import torch
    import torch.distributed as dist

    from obs_color_monitor_tpu_torch import make_batched_step
    from obs_color_monitor_tpu_torch import parallel as par
    from obs_color_monitor_tpu_torch.parallel import mesh as pm

    if dist.is_initialized():
        raise AssertionError("a process group is already initialized")
    mb = par.make_mesh(device=device.type)
    mr = par.make_mesh(axis=par.SPATIAL_AXIS, device=device.type)
    try:
        backend = str(dist.get_backend())
        if backend != ("nccl" if device.type == "cuda" else "gloo"):
            raise AssertionError(f"make_mesh on {device.type} started a {backend} group")
        dev = par.mesh_device(mb)
        frames, packed, tms = mesh_inputs(dev, h, w, b)
        step = make_batched_step(h, w, mesh=mb, scale=2, input_format="packed")
        steps = mesh_steps(pm, mb, mr)
        outs, counts = {}, {}
        for name, (call, eager) in mesh_calls(
                par, mb, mr, steps, frames, packed, tms, step).items():
            if device.type == "cuda":
                torch.cuda.synchronize()
            reset_counts()
            out = call()
            counts[name] = path_counts(name, read_counts(), ("K1", "K6"), device, both_as="K6")
            outs[name] = to_host(out)
            if device.type != "cuda":
                continue
            if (counts[name]["K1"], counts[name]["K6"], counts[name]["K3"]) != (1, 1, 0):
                raise AssertionError(f"{name}: {counts[name]}, expected one K1 and one K2 "
                                     "launch and no K3")
            compare_fields(f"{name}: the replay vs its eager body", outs[name], to_host(eager()))
        if device.type == "cuda":
            graphs = {k: s.graphs for k, s in {**steps, "batched step": step}.items()}
            print(f"mesh graphs held per step: {graphs}  [{card}]", flush=True)
            if set(graphs.values()) != {1}:
                raise AssertionError(f"mesh steps: {graphs} graphs, expected one each")
        times = (mesh_times(par, mb, mr, steps, frames, packed, tms, step, card)
                 if timing else {})
    finally:
        dist.destroy_process_group()
    return outs, counts, times


def mesh_busy(fns: dict, calls: int = 10) -> dict:
    """{name: (device busy ms, host window ms)} per call of each function
    under torch.profiler (the device's activity only, so that the host's
    own tracing does not stretch the window) over ``calls`` calls: the
    union of its device intervals (kernels, copies) against the wall time
    of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for k, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1000 / calls
        out[k] = (busy_ms(device_events(prof)) / calls, window)
    return out


def mesh_times(par, mb, mr, steps, frames, packed, tms, step, card: str) -> dict:
    """ms per frame of each mesh path (CUDA events, as ``time_ms``), replayed
    (the public call) and as its step's eager body, the batched step with a
    mesh, the unsharded analysis and the all-reduce alone; then the device
    busy share of each replay and each eager body (torch.profiler)."""
    import torch
    import torch.distributed as dist

    from obs_color_monitor_tpu_torch.ops.fused import analyze

    w = frames.shape[2]
    counts = torch.zeros(256 * 256 + 3 * 256 * w, dtype=torch.int32, device=frames.device)
    pipe = steps["spatial_pipeline rgb"]
    paths = {
        "batch_analyze B=2": (lambda: par.batch_analyze(frames, mb, cs=2),
                              lambda: steps["batch_analyze"].eager(frames)),
        "spatial_analyze": (lambda: par.spatial_analyze(frames[0], mr, cs=2),
                            lambda: steps["spatial_analyze rgb"].eager(frames[0])),
        "spatial_pipeline": (lambda: par.spatial_pipeline(frames[0], mr, cs=2, tm=1.0, **MESH_OV),
                             lambda: pipe.eager(frames[0], 1.0)),
    }
    fns = {}
    for k, (replay, eager) in paths.items():
        fns[f"mesh {k} replay"] = replay
        fns[f"mesh {k} eager"] = eager
    fns["mesh batched step B=2 replay"] = lambda: step(packed, tms)
    fns["unsharded analyze (K1 + K2, no collective) eager"] = lambda: analyze(
        frames[0], 2, scale=1, need_vs=True, need_wv_rgb=True, need_hi_rgb=True)
    fns["all_reduce of the 4K counts alone"] = lambda: dist.all_reduce(counts,
                                                                      group=mr.get_group())
    per_frame = lambda k: MESH_B if "B=2" in k else 1
    t = time_ms(fns, reps=10, inner=5)
    t = {k: v / per_frame(k) for k, v in t.items()}
    for k, (busy, window) in mesh_busy({k: v for k, v in fns.items() if "mesh" in k}).items():
        t[f"{k} busy"] = busy / per_frame(k)
        t[f"{k} window"] = window / per_frame(k)
        t[f"{k} busy share"] = busy / window
        t[f"{k} busy / events"] = t[f"{k} busy"] / t[k]
    t["all_reduce bytes"] = counts.numel() * 4
    return t


def mesh_reference(device, frames, packed, tms, h, w) -> dict:
    """The unsharded port on ``device`` for each mesh path: ``ops/fused.analyze``
    per frame, ``make_batched_step`` without a mesh and the plain overlays."""
    import torch

    from obs_color_monitor_tpu_torch import make_batched_step
    from obs_color_monitor_tpu_torch.ops import overlays as ov
    from obs_color_monitor_tpu_torch.ops.convert import planarize
    from obs_color_monitor_tpu_torch.ops.fused import analyze

    def stats(f, comp):
        y = comp == "yuv"
        res = analyze(f, 2, scale=1, need_vs=True, need_wv_rgb=not y, need_hi_rgb=not y,
                      need_wv_yuv=y, need_hi_yuv=y)
        wv, hi = (res.wv_yuv, res.hi_yuv) if y else (res.wv_rgb, res.hi_rgb)
        return [res.vs_counts, hi.to(torch.uint32), wv]

    ref = {}
    for i, batch in enumerate((frames, frames.flip(0))):
        per_frame = [stats(f, "rgb") for f in batch]
        ref[f"mesh batch_analyze B=2 batch {i}"] = to_host(
            [torch.stack(o) for o in zip(*per_frame)])
    ref["mesh batched step B=2"] = to_host(make_batched_step(
        h, w, scale=2, input_format="packed", device=device)(packed, tms)._asdict())
    k = MESH_OV
    for comp in MESH_COMPONENTS:
        for i in range(2):
            ref[f"mesh spatial_analyze {comp} frame {i}"] = to_host(stats(frames[i], comp))
        for i, tm in MESH_PIPE_CALLS:
            planes = planarize(frames[i])
            ref[f"mesh spatial_pipeline {comp} frame {i} tm {tm}"] = to_host(
                stats(frames[i], comp) + [
                    ov.zebra_planes(planes, k["th_low"], k["th_high"], tm, 2),
                    ov.falsecolor_planes(planes, 2),
                    ov.focus_peaking_planes(planes, k["peak_th"], k["peak_rgba"])])
    return ref


def mesh_halo_pieces(device, frame, n=2, tm=4.0) -> dict:
    """The overlay half of ``spatial_pipeline`` for each of ``n`` ranks,
    emulated in one process: K1 on each rank's rows with the clock
    ``tm + float32(r * H/n)``, then focus peaking's boundary rows corrected
    by K3 from the neighbours' rows (``mesh.peaking_boundary_rows``).  The
    blocks put together must equal K1's overlays of the whole frame: the
    only check on the card of the code that runs when n > 1 (one card)."""
    import torch

    from obs_color_monitor_tpu_torch.ops.convert import packed_view
    from obs_color_monitor_tpu_torch.ops.pipeline import frame_pass
    from obs_color_monitor_tpu_torch.parallel.mesh import peaking_boundary_rows

    kw = dict(packed=True, cs=2, scale=1, with_overlays=True, zb_cs=2, fc_cs=2, **MESH_OV)
    whole = frame_pass(packed_view(frame), tm, **kw)
    hb = frame.shape[0] // n
    parts = []
    reset_counts()
    for r in range(n):
        block = frame[r * hb:(r + 1) * hb].contiguous()
        clock = (torch.full((), tm, dtype=torch.float32, device=device)
                 + torch.full((), float(r * hb), dtype=torch.float32, device=device))
        ds, _, zb, fc, fp = frame_pass(packed_view(block), clock, **kw)
        above = whole[0][:, r * hb - 1:r * hb] if r > 0 else None
        below = whole[0][:, (r + 1) * hb:(r + 1) * hb + 1] if r < n - 1 else None
        parts.append((zb, fc, peaking_boundary_rows(fp, ds, above, below, MESH_OV["peak_th"],
                                                    MESH_OV["peak_rgba"])))
    counts = read_counts()
    for i, name in enumerate(("zebra", "falsecolor", "focuspeaking")):
        got = torch.cat([p[i] for p in parts], dim=1)
        if not torch.equal(got, whole[2 + i]):
            raise AssertionError(f"mesh halo pieces, {n} ranks: {name} differs from the whole "
                                 "frame's")
    if device.type == "cuda" and (counts["K1"], counts["K3"]) != (n, 2 * (n - 1)):
        raise AssertionError(f"mesh halo pieces: {counts}, expected {n} K1 and "
                             f"{2 * (n - 1)} K3 launches")
    print(f"mesh halo pieces, {n} ranks emulated: zebra, false colour and focus peaking equal "
          f"to the whole frame's; launches K1={counts['K1']} K3={counts['K3']}", flush=True)
    return {"K1": counts["K1"], "K3": counts["K3"], "K3 vec": counts["K3 vec"],
            "K1 vec": counts["K1 vec"]}


def phase_mesh(device, card: str, h=H4K, w=W4K) -> tuple[dict, dict]:
    """``obs_color_monitor_tpu_torch.parallel`` on one card: a world-size-1
    NCCL group (``make_mesh``), ``batch_analyze`` on B = 2 4K frames in two
    orders, ``make_batched_step(mesh=)`` at B = 2 packed,
    ``spatial_analyze`` on two 4K frames and ``spatial_pipeline`` on two
    frames at tm 1.0 and 4.0, both component families; each path a replay
    of its captured step with one K1 and one K2 launch, every output equal
    to its step's eager body, to the same calls on the CPU (a gloo group)
    and to the unsharded port on the card; the halo pieces for 2 and 4
    ranks; then the times.  Returns (counts by path, times)."""
    outs, counts, times = run_mesh(device, h, w, MESH_B, timing=device.type == "cuda",
                                   card=card)
    frames, packed, tms = mesh_inputs(device, h, w)
    ref = mesh_reference(device, frames, packed, tms, h, w)
    cpu_outs = outs
    if device.type == "cuda":
        cpu_outs, _, _ = run_mesh(__import__("torch").device("cpu"), h, w, MESH_B)
    for name, got in outs.items():
        compare_fields(f"{name} vs the unsharded port", got, ref[name])
        compare_fields(f"{name} vs the CPU", got, cpu_outs[name])
        print(f"{name}: every output equal to its eager body, the unsharded port and the CPU",
              flush=True)
    for comp in MESH_COMPONENTS:
        a, b = (outs[f"mesh spatial_pipeline {comp} frame 0 tm {tm}"]["3"] for tm in CLOCKS)
        if np.array_equal(a, b):
            raise AssertionError(f"mesh spatial_pipeline {comp}: the zebra did not move")
        a, b = (outs[f"mesh spatial_analyze {comp} frame {i}"]["2"] for i in range(2))
        if np.array_equal(a, b):
            raise AssertionError(f"mesh spatial_analyze {comp}: two frames gave one waveform")
    for n in (2, 4):
        counts[f"mesh halo pieces n={n}"] = mesh_halo_pieces(device, frames[0], n)
    for k, v in times.items():
        unit = "" if "share" in k or "bytes" in k or "/ events" in k else " ms"
        print(f"mesh time {k}: {v:.4f}{unit}  [{card}]", flush=True)
    if times:
        print(f"mesh all_reduce moves {times['all_reduce bytes']} bytes a 4K frame "
              "(256*256 + 3*256*3840 int32)", flush=True)
    return counts, times


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


def cold_ms(fns: dict, reps: int = 15, flush_bytes: int = 256 << 20) -> dict:
    """ms per call of each function with a cold L2: before each call a
    ``flush_bytes`` buffer (five times the H100's 50 MB L2) is written, then
    CUDA events around the call alone; the median of ``reps``.  The write
    runs long enough on the card that the call is queued behind it, so the
    host's launch time is not in the interval."""
    import torch

    buf = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    times = {k: [] for k in fns}
    for r in range(reps):
        for k, fn in fns.items():
            buf.fill_(r & 255)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
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


def library_counts_batched(u, v, data, mask):
    """``(fn, check)`` as :func:`library_counts` for a batch (a leading B on
    each input): one ``torch.bincount`` over every frame's index, frame b's
    bins offset by b times one frame's bin count."""
    import torch

    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    b = u.shape[0]
    parts = [bincount_index(u[i], v[i], data[i], mask[i]) for i in range(b)]
    n = parts[0][1]
    idx = torch.cat([p[0] + i * n for i, p in enumerate(parts)])
    fn = lambda: torch.bincount(idx, minlength=n * b)

    def check(name):
        bins = fn().to(torch.int32).view(b, n)
        vs, wv = ss.vs_wv_counts(u, v, data, mask)
        if not (torch.equal(bins[:, :65536].reshape(vs.shape), vs)
                and torch.equal(bins[:, 65536:n - 1].reshape(wv.shape), wv)):
            raise AssertionError(f"{name}: torch.bincount differs from the kernel's counts")
        print(f"{name}: torch.bincount equals the kernel's counts", flush=True)

    return fn, check


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


def settled_dock(device, nv12):
    """A streaming ``models.Dock`` on 4K NV12 frames (all six scopes) with
    its settled route captured: three push + render frames."""
    from obs_color_monitor_tpu_torch import DockConfig, ROIConfig
    from obs_color_monitor_tpu_torch.models import Dock

    dock = Dock(DockConfig(show_focuspeaking=True), roi=ROIConfig(interleave=0), device=device)
    for _ in range(3):
        dock.push_nv12(*nv12)
        dock.render_async()
    return dock


def phase_timing(device, card: str) -> tuple[dict, dict]:
    """ms per call of the steps (eager and replayed), the kernels, their
    plain versions and the library calls, and each kernel's bound at the
    timed shapes."""
    import torch

    from obs_color_monitor_tpu_torch import (
        DockConfig, make_batched_step, make_dock_step, make_full_step)
    from obs_color_monitor_tpu_torch.ops import convert as cv
    from obs_color_monitor_tpu_torch.ops import decode as dec
    from obs_color_monitor_tpu_torch.ops import fused_overlays as fo
    from obs_color_monitor_tpu_torch.ops import pipeline as pl
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    fns, bounds = {}, {}
    # the kernels' clock as the steps hand it over: a float32 in device
    # memory (a float would add a fill launch to each timed call)
    tm1 = torch.ones((), dtype=torch.float32, device=device)
    step = make_full_step(H4K, W4K, scale=2, input_format="packed", device=device)
    kw = dict(packed=True, cs=2, scale=2, **OV_ARGS)
    h, w = H4K // 2, W4K // 2
    for kind in ("random", "flat"):
        x = as_input(make_frame(H4K, W4K, kind, 3), True, device)
        inputs = pl.stats_inputs(*pl.frame_pass_reference(x, 1.0, **kw)[:2], False)
        library, check = library_counts(*inputs)
        check(f"K2 library {kind}")
        fns[f"step_{kind}"] = lambda x=x: step(x, 1.0)  # the graph replay
        fns[f"step_eager_{kind}"] = lambda x=x: step.eager(x, 1.0)
        fns[f"k1_{kind}"] = lambda x=x: pl.frame_pass(x, tm1, **kw)
        fns[f"k1_plain_{kind}"] = lambda x=x: pl.frame_pass_reference(x, 1.0, **kw)
        # the scale-only pass (analyze, the docks, K9): K1 without overlays
        fns[f"k1_scale_{kind}"] = lambda x=x: pl.frame_pass(x, 1.0, with_overlays=False, **kw)
        fns[f"k1_scale_plain_{kind}"] = lambda x=x: pl.frame_pass_reference(
            x, 1.0, with_overlays=False, **kw)
        fns[f"k2_{kind}"] = lambda i=inputs: ss.vs_wv_counts(*i)
        fns[f"k2_plain_{kind}"] = lambda i=inputs: ss.vs_wv_counts_reference(*i)
        fns[f"k2_library_{kind}"] = library
    # K1's overlay+scale pass: the frame read once, three full-res overlays
    # and the scaled/YUV planes written; ~60 ops per full-res pixel, ~30 per
    # scaled one.  Its scale-only pass: the frame read, the scaled planes
    # written.
    bounds["K1"] = bound(H4K * W4K * (4 + 12) + h * w * 7, H4K * W4K * 60 + h * w * 30)
    bounds["K1 scale"] = bound(H4K * W4K * 4 + h * w * 7, h * w * 30)
    # K2: u, v, data and mask read once, both histograms written
    bounds["K2"] = bound(h * w * 6 + 65536 * 4 + 3 * 256 * w * 4, h * w * 10)

    dock_nv12 = make_dock_step(H4K, W4K, scale=2, input_format="nv12",
                               dock=DockConfig(show_focuspeaking=True), device=device)
    y, uv = to_device(make_nv12(H4K, W4K, 5), device)
    y16, uv16 = to_device(make_nv12(H4K, W4K, 6, 10, True), device)
    fns["dock_nv12"] = lambda: dock_nv12((y, uv), 1.0)
    fns["dock_nv12_eager"] = lambda: dock_nv12.eager((y, uv), 1.0)
    fns["k4"] = lambda: dec.nv12_decode(y, uv, cs=2)
    fns["k4_plain"] = lambda: cv.nv12_packed_reference(y, uv, 2)
    fns["k5"] = lambda: dec.nv12_16_decode(y16, uv16, cs=2, shift=8)
    fns["k5_plain"] = lambda: cv.nv12_16_packed_reference(y16, uv16, 2, 8)
    bounds["K4"] = bound(H4K * W4K * (1 + 0.5 + 4), H4K * W4K * 25)
    bounds["K5"] = bound(H4K * W4K * (2 + 1 + 4), H4K * W4K * 35)
    bounds["K4 b2"] = bound(2 * H4K * W4K * (1 + 0.5 + 4), 2 * H4K * W4K * 25)
    bounds["K5 b2"] = bound(2 * H4K * W4K * (2 + 1 + 4), 2 * H4K * W4K * 35)
    # K3 at the dock's shapes: the scaled capture, packed output
    cap = pl.frame_pass_reference(cv.nv12_packed_reference(y, uv, 2), packed=True, cs=2,
                                  scale=2, with_overlays=False)[0]
    k3kw = dict(OV_ARGS, packed_out=True)
    fns["k3"] = lambda: fo.fused_overlays_planes(cap, tm1, **k3kw)
    fns["k3_plain"] = lambda: fo.fused_overlays_reference(cap, 1.0, **k3kw)
    bounds["K3"] = bound(h * w * (4 + 12), h * w * 60)
    # one output (the per-scope route): focus peaking alone
    fp_only = dict(k3kw, outputs=(False, False, True))
    fns["k3_fp"] = lambda: fo.fused_overlays_planes(cap, tm1, **fp_only)
    fns["k3_fp_plain"] = lambda: fo.fused_overlays_reference(cap, 1.0, **fp_only)
    bounds["K3 one output"] = bound(h * w * (4 + 4), h * w * 25)
    # and at full resolution (the dock with overlays_on_capture=False)
    full = as_input(make_frame(H4K, W4K, "random", 4), False, device)
    fns["k3_fullres"] = lambda: fo.fused_overlays_planes(full, tm1, **k3kw)
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
    # K6 at the mesh paths' shape, where most of its launches are: both
    # counts of a whole 4K frame at scale 1
    ds1, yuv1, *_ = pl.frame_pass_reference(x, packed=True, cs=2, scale=1, with_overlays=False)
    k6_4k_in = pl.stats_inputs(ds1, yuv1, False)
    fns["k6_4k_library"], check = library_counts(*k6_4k_in)
    check("K6 4K scale 1 library")
    fns["k6_4k"] = lambda: ss.vs_wv_counts(*k6_4k_in)
    fns["k6_4k_plain"] = lambda: ss.vs_wv_counts_reference(*k6_4k_in)
    bounds["K6 4K"] = bound(H4K * W4K * 6 + 65536 * 4 + 3 * 256 * W4K * 4, H4K * W4K * 10)
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
    fns["dock_nv12_dynamic"] = lambda: dyn.eager((y, uv), 1.0, roi_t)
    fns["dock_nv12_dynamic_graph"] = lambda: dyn((y, uv), 1.0, roi_t)
    # the settled streaming Dock: a push and a render (the replay and the
    # publication), and its captured stream step's function eagerly
    dock = settled_dock(device, (y, uv))
    wv = dock.waveform
    fns["dock_settled"] = lambda: (dock.push_nv12(y, uv), dock.render_async())
    fns["dock_settled_eager"] = lambda: dock._settled.eager((y, uv), 1.0, wv._buf[wv._r_buf])
    # the batched step at B = 1, 2, 4 on 4K packed frames, eager and replayed
    bsteps = {}
    for b in (1, 2, 4):
        _, batch, tms = batch_input(H4K, W4K, "packed", b, 1100, device)
        bsteps[b] = (make_batched_step(H4K, W4K, scale=2, input_format="packed",
                                       device=device), batch, tms)
        fns[f"batched_{b}"] = lambda b=b: bsteps[b][0](*bsteps[b][1:])
        fns[f"batched_{b}_eager"] = lambda b=b: bsteps[b][0].eager(*bsteps[b][1:])
    # the batched kernels: K1 and K2 on the B = 4 batch (its overlay+scale
    # pass, and K2 on its 1920x1080 captures), K4 / K5 on B = 2 NV12 / P010
    b4 = bsteps[4][1]
    fns["k1_b4"] = lambda: pl.frame_pass(b4, bsteps[4][2], **kw)
    k2_b4 = pl.stats_inputs(*pl.frame_pass(b4, bsteps[4][2], **kw)[:2], False)
    fns["k2_b4"] = lambda: ss.vs_wv_counts(*k2_b4)
    fns["k2_b4_library"], check = library_counts_batched(*k2_b4)
    check("K2 batched B=4 library")
    _, (yb, uvb), _ = batch_input(H4K, W4K, "nv12", 2, 1200, device)
    y16b, uv16b = (torch.stack([t, t]) for t in (y16, uv16))
    fns["k4_b2"] = lambda: dec.nv12_decode(yb, uvb, cs=2)
    fns["k5_b2"] = lambda: dec.nv12_16_decode(y16b, uv16b, cs=2, shift=8)
    bounds["K1 b4"] = tuple(v * 4 if i == 0 else v for i, v in enumerate(bounds["K1"]))
    bounds["K2 b4"] = tuple(v * 4 if i == 0 else v for i, v in enumerate(bounds["K2"]))
    k2r_in = pl.stats_inputs(*pl.frame_pass_reference(cv.nv12_packed_reference(y, uv, 2),
                                                      packed=True, cs=2, scale=2,
                                                      with_overlays=False)[:2], False)
    fns["k2_rect"] = lambda: ss.vs_wv_counts(*k2r_in, rect=roi_t)
    fns["k2_rect_plain"] = lambda: ss.vs_wv_counts_reference(*k2r_in, rect=roi_t)
    fns["k2_rect_library"], check = library_counts(*k2r_in, rect=roi_t)
    check("K2 rect library")
    fns["k3_rect"] = lambda: fo.fused_overlays_planes(cap, tm1, rect=roi_t, **k3kw)
    fns["k3_rect_plain"] = lambda: fo.fused_overlays_reference(cap, 1.0, rect=roi_t, **k3kw)
    rect_px = (ROI[2] - ROI[0]) * (ROI[3] - ROI[1])
    bounds["K2 rect"] = bound(rect_px * 6 + 65536 * 4 + 3 * 256 * w * 4, rect_px * 10)
    bounds["K3 rect"] = bounds["K3"]
    t = time_ms(fns)
    for k, v in t.items():
        print(f"time {k}: {v:.4f} ms  [{card}]", flush=True)
    for b in bsteps:
        for k in (f"batched_{b}", f"batched_{b}_eager"):
            t[k + "_per_frame"] = t[k] / b
            print(f"time {k} per frame: {t[k] / b:.4f} ms  [{card}]", flush=True)
    # K3's shapes once more with the L2 flushed before each call: the 1080p
    # capture and its outputs (33 MB) fit the 50 MB L2, so a replay loop can
    # read them below the HBM bound
    for k, v in cold_ms({k: fns[k] for k in ("k3", "k3_fullres", "k3_rect", "k3_fp")}).items():
        t[k + "_cold"] = v
        print(f"cold time {k}: {v:.4f} ms  [{card}]", flush=True)
    kernels = {k: fn for k, fn in fns.items() if k.startswith("k") and "plain" not in k}
    dev = device_ms(kernels, card)
    # the kernels' own calls (not the library's: bincount reads its maximum
    # back to the host) as graph replays
    graph = graph_ms({k: fn for k, fn in kernels.items() if "library" not in k})
    for k, v in graph.items():
        print(f"graph time {k}: {v:.4f} ms  [{card}]", flush=True)
        dev[k] += (v,)
    for k, (ms, by) in sorted(bounds.items()):
        print(f"bound {k}: {ms:.4f} ms ({by})", flush=True)
    return t, bounds, dev


def device_events(prof) -> list:
    """The device's own work in a profile: its kernels and copies.  A
    record_function span shows on the device timeline too, over kernels
    counted on their own, so it is left out."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def graph_ms(fns: dict, calls: int = 10, reps: int = 20) -> dict:
    """ms per call of each function with the host left out: ``calls`` calls
    captured in one CUDA graph, replayed ``reps`` times between CUDA events
    (kernels that overlap count once, the gaps between them count)."""
    import torch

    out = {}
    for k, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        out[k] = start.elapsed_time(end) / (reps * calls)
    return out


def device_ms(fns: dict, card: str, calls: int = 20) -> dict:
    """Device time per call of each function under torch.profiler over
    ``calls`` calls: {key: (sum, span)}, the sum of its kernels' durations
    and the median span from its first kernel's start to its last kernel's
    end (kernels that overlap count once).  Unlike the event times of
    :func:`time_ms`, both leave out the host's issue time, which a wrapper
    around a short kernel does not hide.  The printed line also splits the
    sum by kernel name."""
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
        events = sorted(device_events(prof), key=lambda e: e.time_range.start)
        names: dict[str, float] = {}
        for e in events:
            m = re.search(r"(\w+_kernel)\b", e.name)
            name = m.group(1) if m else e.name[:40]
            names[name] = names.get(name, 0.0) + e.time_range.elapsed_us() / calls / 1000
        total = sum(names.values())
        per = len(events) // calls
        span = None
        if per and len(events) == per * calls:
            span = statistics.median(
                max(e.time_range.end for e in events[i:i + per]) - events[i].time_range.start
                for i in range(0, len(events), per)) / 1000
        out[k] = (total, span)
        split = ", ".join(f"{n} {ms:.4f}" for n, ms in names.items())
        print(f"device time {k}: {total:.4f} ms, span {span if span is None else f'{span:.4f}'}"
              f" ms ({split})  [{card}]", flush=True)
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
    """Profiler windows over each step, replayed and (but the Dock) eager:
    the device's busy share of the window is the replay's gain to read."""
    import torch

    from obs_color_monitor_tpu_torch import (
        DockConfig, make_batched_step, make_dock_step, make_full_step)

    full = make_full_step(H4K, W4K, scale=2, input_format="packed", device=device)
    x = as_input(make_frame(H4K, W4K, "random", 3), True, device)
    dock = make_dock_step(H4K, W4K, scale=2, input_format="nv12",
                          dock=DockConfig(show_focuspeaking=True), device=device)
    nv12 = to_device(make_nv12(H4K, W4K, 5), device)
    p010 = make_dock_step(H4K, W4K, scale=2, input_format="nv12", nv12_shift=8,
                          dock=DockConfig(show_focuspeaking=True), device=device)
    dyn = make_dock_step(H4K, W4K, scale=2, input_format="nv12", dynamic_roi=True,
                         dock=DockConfig(show_focuspeaking=True), device=device)
    roi_t = torch.tensor(ROI, dtype=torch.int32, device=device)
    _, batch, tms = batch_input(H4K, W4K, "packed", 4, 1100, device)
    batched = make_batched_step(H4K, W4K, scale=2, input_format="packed", device=device)
    for label, fn, frame in (
        ("full_step", full, x), ("full_step eager", full.eager, x),
        ("dock_nv12", dock, nv12), ("dock_nv12 eager", dock.eager, nv12),
        ("dock_p010", p010, to_device(make_nv12(H4K, W4K, 6, 10, True), device)),
        ("dock_nv12_dynamic", lambda f, tm: dyn(f, tm, roi_t), nv12),
        ("dock_nv12_dynamic eager", lambda f, tm: dyn.eager(f, tm, roi_t), nv12),
        ("batched B=4", lambda f, tm: batched(f, tms), batch),
        ("batched B=4 eager", lambda f, tm: batched.eager(f, tms), batch),
    ):
        profile_window(fn, frame, label, card)
    # the streaming Dock in steady state: a push and a render per frame
    sdock = settled_dock(device, nv12)
    profile_window(lambda f, tm: (sdock.push_nv12(*f), sdock.render_async())[1], nv12,
                   "models.Dock nv12 settled", card)


# ---------------------------------------------------------------------------
# the host pipeline: the driver-fed Dock, the driver soak and the CLI
# ---------------------------------------------------------------------------

DRIVER_FRAMES = 24  # the driver-fed Dock's equality run
SOAK_FRAMES = 240  # each soak window (unpaced, then paced at SOAK_FPS)
SOAK_FPS = 60.0
CLI_FRAMES = 16


def nv12_buffers(h: int, w: int, n: int, seed: int, bits: int = 8, msb: bool = False) -> list:
    """``n`` NV12 (or P010) frames, each one contiguous (h * 3/2, w) buffer
    whose row slices are its planes, as a file read or a decoder gives
    them."""
    return [np.concatenate(make_nv12(h, w, seed + i, bits, msb)) for i in range(n)]


def panel_dock(device, interleave=None):
    """The driver phases' Dock: the reference new-dock panel with focus
    peaking shown, BT709 (AUTO), stats at target_scale=2."""
    from obs_color_monitor_tpu_torch import DockConfig, ROIConfig
    from obs_color_monitor_tpu_torch.models import Dock

    roi = ROIConfig() if interleave is None else ROIConfig(interleave=interleave)
    return Dock(DockConfig(show_focuspeaking=True), roi=roi, device=device)


def check_panels(what: str, got: list, want: list) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} panels, expected {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{what}: panel {i} differs")


def phase_driver_dock(device, h=H4K, w=W4K, frames=DRIVER_FRAMES, pool=6) -> dict:
    """A fresh ``models.Dock(DockConfig(show_focuspeaking=True))`` behind a
    started ``PipelineDriver(dock=, on_panel=)``: ``frames`` NV12 pushes
    from a pool of pre-made frames, a flush after each so that nothing
    drops.  Every panel handed to on_panel equals a second Dock on the card
    driven directly (push_nv12 + render); the last panel and the published
    vectorscope, waveform and histogram equal a CPU Dock fed the same
    frames; no worker error, one settled graph, no hub fan-out after the
    first frames.  Then the P010 form (K5) on 3 frames."""
    from obs_color_monitor_tpu_torch.ops.convert import nv12_shift
    from obs_color_monitor_tpu_torch.pipeline import PipelineDriver

    by_path = {}
    for name, bits, n, pool_n, interleave in (
            ("driver-fed models.Dock nv12", 8, frames, pool, None),
            ("driver-fed models.Dock p010", 10, 3, 3, 0)):
        shift = nv12_shift(bits, True) if bits != 8 else 0
        bufs = nv12_buffers(h, w, pool_n, 1300 + bits, bits, bits != 8)
        seq = [bufs[i % pool_n] for i in range(n)]
        dock = panel_dock(device, interleave)
        panels, fanout = [], []
        drv = PipelineDriver(dock=dock, on_panel=lambda p: panels.append(p.cpu().numpy()))
        process = dock.hub.process
        dock.hub.process = lambda *a, **k: (fanout.append(len(panels)), process(*a, **k))[1]
        reset_counts()
        drv.start()
        try:
            for b in seq:
                if not drv.push_nv12(b[:h], b[h:], shift=shift):
                    raise AssertionError(f"{name}: a push dropped with a flush between pushes")
                drv.flush()
        finally:
            drv.stop()
        counts = path_counts(name, read_counts(), ("K1", "K2", "K3", "K5" if bits != 8 else "K4"),
                             device)
        s = drv.stats
        graphs = dock._settled.graphs if dock._settled is not None else 0
        late = [i for i in fanout if i >= 4]
        print(f"{name}: {s}, settled graphs {graphs}, hub fan-out at frames {fanout}", flush=True)
        if s["errors"] or s["dropped"] or s["processed"] + s["interleave_skipped"] != n:
            raise AssertionError(f"{name}: {s}")
        if device.type == "cuda" and graphs != 1:
            raise AssertionError(f"{name}: {graphs} settled graphs, expected 1")
        if late:
            raise AssertionError(f"{name}: the hub fan-out ran in steady state, frames {late}")
        direct, want = panel_dock(device, interleave), []
        for b in seq:
            direct.push_nv12(b[:h], b[h:], shift=shift)
            want.append(direct.render())
        check_panels(f"{name} vs a directly driven Dock", panels, want)
        if bits == 8:
            cpu = panel_dock("cpu", interleave)
            for b in seq:  # pushes alone: each frame through the hub fan-out
                cpu.push_nv12(b[:h], b[h:])
            check_panels(f"{name}: last panel vs the CPU Dock", panels[-1:], [cpu.render()])
            for what, a, b in (
                    ("vectorscope", dock.vectorscope._read().cpu().numpy(),
                     cpu.vectorscope._read().numpy()),
                    ("waveform", dock.waveform.counts(), cpu.waveform.counts()),
                    ("histogram", dock.histogram.counts(), cpu.histogram.counts())):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name}: the published {what} differs from the CPU's")
        print(f"{name}: {n} panels equal to a directly driven Dock"
              + (", the last panel and the published vectorscope, waveform and histogram "
                 "equal to the CPU Dock's" if bits == 8 else ""), flush=True)
        by_path[name] = counts
    return by_path


def percentile(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q / 100 * len(xs)))]


def busy_ms(events) -> float:
    """The union of the device intervals of a profile, ms (the upload
    stream's copies overlap the worker's kernels)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1000


def soak_window(drv, bufs, h, n, fps, pushes, landed, profile=False):
    """``n`` pushes, unpaced (``fps`` None) or paced, then a flush: the
    window's metrics.  ``pushes`` / ``landed`` are the driver's running
    lists (the k-th landed panel is the k-th accepted push's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    k0, stats0, stage0 = len(pushes), drv.stats, drv.staging
    activity = ProfilerActivity.CUDA if drv.device.type == "cuda" else ProfilerActivity.CPU
    prof = tprofile(activities=[activity]) if profile else None
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    for i in range(n):
        if fps:
            due = t0 + i / fps
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
        t = time.perf_counter()
        b = bufs[i % len(bufs)]
        if drv.push_nv12(b[:h], b[h:]):
            pushes.append(t)
    drv.flush(timeout=120)
    if drv.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = {"pushed": drv.stats["pushed"] - stats0["pushed"],
           "dropped": drv.stats["dropped"] - stats0["dropped"],
           "processed": drv.stats["processed"] - stats0["processed"],
           "errors": drv.stats["errors"] - stats0["errors"]}
    lat = [(landed[k] - pushes[k]) * 1e3 for k in range(k0, len(pushes))]
    out["sink_fps"] = (len(pushes) - k0) / (landed[-1] - pushes[k0])
    out["lat_p50"], out["lat_p90"], out["lat_p99"] = (percentile(lat, q) for q in (50, 90, 99))
    out["n_lat"] = len(lat)
    uploads = max(1, drv.staging["uploads"] - stage0["uploads"])
    out["host_copy_ms"] = (drv.staging["host_copy_s"] - stage0["host_copy_s"]) / uploads * 1e3
    out["slot_wait_ms"] = (drv.staging["wait_s"] - stage0["wait_s"]) / uploads * 1e3
    out["window_s"] = t1 - t0
    if prof is not None:
        prof.stop()
        events = device_events(prof)
        h2d = [e for e in events if "HtoD" in e.name]
        out["busy"] = busy_ms(events) / ((t1 - t0) * 1e3)
        out["h2d_ms"] = sum(e.time_range.elapsed_us() for e in h2d) / 1000 / max(1, len(h2d))
        out["h2d_n"] = len(h2d)
    return out


def phase_driver_soak(device, card: str, h=H4K, w=W4K, frames=SOAK_FRAMES) -> dict:
    """The driver on a fresh Dock (interleave 0: every frame analyzed and
    rendered), fed 4K NV12 frames from this thread while its worker warms
    up and captures the settled step (a thread-local capture beside the
    producer's uploads); then the measured windows: unpaced (push as fast
    as the producer can) and paced at 60 fps, each once plain and once
    under torch.profiler (the device busy share and the uploads' device
    time).  The sink (on_panel) copies each panel to the host.  Fails on a
    worker error, on more than one settled graph, and if the paced run
    drops a frame while the unpaced run sustains more than 60 fps."""
    from obs_color_monitor_tpu_torch.pipeline import PipelineDriver

    bufs = nv12_buffers(h, w, 6, 1400)
    dock = panel_dock(device, 0)
    pushes, landed = [], []

    def on_panel(p):
        p.cpu()
        landed.append(time.perf_counter())

    drv = PipelineDriver(dock=dock, on_panel=on_panel)
    reset_counts()
    drv.start()
    try:
        warm = soak_window(drv, bufs, h, 40, None, pushes, landed)
        runs = {"unpaced": soak_window(drv, bufs, h, frames, None, pushes, landed),
                "paced": soak_window(drv, bufs, h, frames, SOAK_FPS, pushes, landed),
                "unpaced profiled": soak_window(drv, bufs, h, frames // 2, None, pushes, landed,
                                                True),
                "paced profiled": soak_window(drv, bufs, h, frames // 2, SOAK_FPS, pushes,
                                              landed, True)}
    finally:
        drv.stop()
    name = "driver soak"
    counts = path_counts(name, read_counts(), ("K1", "K2", "K3", "K4"), device)
    graphs = dock._settled.graphs if dock._settled is not None else 0
    print(f"soak warm-up (fresh Dock, capture during pushes): {warm['pushed']} pushed, "
          f"{warm['processed']} processed, {warm['dropped']} dropped, errors {warm['errors']}, "
          f"settled graphs {graphs}  [{card}]", flush=True)
    for label, r in runs.items():
        line = (f"soak {label}: pushed {r['pushed']} processed {r['processed']} dropped "
                f"{r['dropped']}, sink {r['sink_fps']:.2f} fps, push-to-panel ms median "
                f"{r['lat_p50']:.3f} p90 {r['lat_p90']:.3f} p99 {r['lat_p99']:.3f} "
                f"(n {r['n_lat']}), producer ms/frame: host copy into pinned "
                f"{r['host_copy_ms']:.3f}, slot wait {r['slot_wait_ms']:.3f}")
        if "busy" in r:
            line += (f", device busy {100 * r['busy']:.1f}% of the window, H2D "
                     f"{r['h2d_ms']:.4f} ms/copy ({r['h2d_n']} copies)")
        print(line + f", window {r['window_s']:.3f} s  [{card}]", flush=True)
    errors = warm["errors"] + sum(r["errors"] for r in runs.values())
    if errors:
        raise AssertionError(f"{name}: {errors} worker errors")
    if device.type == "cuda" and graphs != 1:
        raise AssertionError(f"{name}: {graphs} settled graphs, expected 1")
    if runs["unpaced"]["sink_fps"] > SOAK_FPS and runs["paced"]["dropped"]:
        raise AssertionError(f"{name}: the paced run dropped {runs['paced']['dropped']} frames "
                             f"while the unpaced run sustains {runs['unpaced']['sink_fps']:.1f}")
    return {name: counts}


def read_png(path) -> np.ndarray:
    """A PNG as an array: through PIL where present, else the filter-0 rows
    that the package's own encoder writes (``utils.image_io.encode_png``)."""
    import io
    import struct
    import zlib

    data = path.read_bytes() if hasattr(path, "read_bytes") else bytes(path)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        return np.asarray(Image.open(io.BytesIO(data)))
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, _, ctype = ihdr[:4]
    c = 4 if ctype == 6 else 3
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    if (rows[:, 0] != 0).any():
        raise AssertionError("read_png: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, c)


def y4m_frames(path, w: int, h: int) -> list:
    """The raw (Y, U, V) C444 planes of each frame of a Y4M file."""
    data = path.read_bytes()
    pos, out, n = data.index(b"\n") + 1, [], w * h
    while pos < len(data):
        if data[pos:pos + 6] != b"FRAME\n":
            raise AssertionError(f"{path}: no frame marker at byte {pos}")
        pos += 6
        out.append(tuple(np.frombuffer(data, np.uint8, n, pos + k * n).reshape(h, w)
                         for k in range(3)))
        pos += 3 * n
    return out


def phase_cli(device, h=H4K, w=W4K, frames=CLI_FRAMES) -> dict:
    """``python -m obs_color_monitor_tpu_torch`` in process (``main([...])``)
    on ``--device cuda``, on a 4K ``.nv12`` file and a ``.p010`` file:
    ``dock`` (the fan-out route), ``dock --one-program``, ``scope
    vectorscope`` and ``scope waveform``, ``dock --out-video`` (every
    recorded frame equal to the Y4M encoding of a directly driven Dock's
    panel), ``dock --live`` (every published frame once, in order, frame
    i's upload issued before frame i-1's publication, one image fetched
    over HTTP from localhost equal to one of them), ``dock`` on P010 and
    ``info``.  Each command exits 0; each PNG equals the panel (or scope
    image) of a Dock (or scope) driven directly with the same frames."""
    import contextlib
    import io
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from pathlib import Path

    from obs_color_monitor_tpu_torch import ROIConfig, VectorscopeConfig, WaveformConfig
    from obs_color_monitor_tpu_torch.__main__ import main as cli
    from obs_color_monitor_tpu_torch.models import Dock, Vectorscope, Waveform
    from obs_color_monitor_tpu_torch.ops import convert
    from obs_color_monitor_tpu_torch.pipeline import live
    from obs_color_monitor_tpu_torch.pipeline.ingest import NV12Source
    from obs_color_monitor_tpu_torch.pipeline.sinks import rgb_to_yuv_limited
    from obs_color_monitor_tpu_torch.utils.image_io import encode_frame

    by_path = {}
    size = ["--size", f"{w}x{h}", "--device", device.type]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        nv12, p010 = tmp / "x.nv12", tmp / "x.p010"
        pool = nv12_buffers(h, w, 4, 1500)
        with open(nv12, "wb") as f:
            for i in range(frames):
                f.write(pool[i % len(pool)].tobytes())
        with open(p010, "wb") as f:
            for b in nv12_buffers(h, w, 3, 1510, 10, True):
                f.write(b.astype("<u2").tobytes())
        src = NV12Source(str(nv12), w, h, cs=2)
        planes = list(src.frames_nv12(frames))

        def run(name, args, needs):
            out = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli(args + (size if args[0] != "info" else size[2:]))
            dt = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"cli {name}: exit {rc}\n{out.getvalue()}")
            if needs:
                by_path[f"cli {name}"] = path_counts(f"cli {name}", read_counts(), needs, device)
            print(f"cli {name}: exit 0 in {dt:.2f} s: {out.getvalue().strip()[-300:]}",
                  flush=True)
            return out.getvalue()

        def same(name, png, want):
            got = read_png(png)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"cli {name}: the PNG differs from the directly driven "
                                     "result")
            print(f"cli {name}: PNG {got.shape[1]}x{got.shape[0]} equal to the directly "
                  "driven result", flush=True)

        def fanout_dock(seq, shift=0):
            d = Dock(roi=ROIConfig(target_scale=2, interleave=1), device=device)
            for y, uv in seq:
                d.push_nv12(y, uv, cs=2, shift=shift)
            return d.render(width=512, height=1536)

        # the dock, fan-out route: pushes, one render at the end
        run("dock nv12", ["dock", "--input", str(nv12), "--frames", str(frames),
                          "--out", str(tmp / "dock.png")], ("K1", "K2", "K3", "K4"))
        same("dock nv12", tmp / "dock.png", fanout_dock(planes))
        # --one-program: host-decoded RGBA through make_dock_step
        run("dock --one-program", ["dock", "--input", str(nv12), "--frames", str(frames),
                                   "--one-program", "--out", str(tmp / "one.png")],
            ("K1", "K2", "K3"))
        d = Dock(roi=ROIConfig(target_scale=2, interleave=1), device=device)
        for n, f in enumerate(src.frames(frames)):
            want = d.render_device(f, tm=n / 15.0, width=512, height=1536)
        same("dock --one-program", tmp / "one.png", want)
        # one scope each
        for scope, cls, cfg, needs in (
                ("vectorscope", Vectorscope, VectorscopeConfig, ("K1", "K4", "K7")),
                ("waveform", Waveform, WaveformConfig, ("K1", "K4", "K8"))):
            run(f"scope {scope}", ["scope", scope, "--input", str(nv12), "--frames",
                                   str(frames), "--out", str(tmp / f"{scope}.png")], needs)
            sc = cls(cfg(target_scale=2), device=device)
            for y, uv in planes:
                sc.push_nv12(y, uv, cs=2)
                sc._hub.tick()
            same(f"scope {scope}", tmp / f"{scope}.png", sc.render())
        # --out-video: a render per frame (the settled route), recorded
        run("dock --out-video", ["dock", "--input", str(nv12), "--frames", str(frames),
                                 "--out", str(tmp / "video.png"),
                                 "--out-video", str(tmp / "panel.y4m")],
            ("K1", "K2", "K3", "K4"))
        d, want = Dock(roi=ROIConfig(target_scale=2, interleave=1), device=device), []
        for y, uv in planes:
            d.push_nv12(y, uv, cs=2)
            want.append(d.render(width=512, height=1536))
        same("dock --out-video", tmp / "video.png", want[-1])
        rec = y4m_frames(tmp / "panel.y4m", 512, 1536)
        if len(rec) != frames or any(
                not all(np.array_equal(a, b) for a, b in zip(r, rgb_to_yuv_limited(p, 2)))
                for r, p in zip(rec, want)):
            raise AssertionError("cli dock --out-video: the recording differs from the "
                                 "directly driven panels")
        print(f"cli dock --out-video: {len(rec)} recorded frames equal to the directly driven "
              "panels' Y4M encoding", flush=True)
        # --live: publication order, one frame late, and one HTTP fetch
        events, published, fetched = [], [], []
        upload, publish = convert.nv12_device_planes, live.MJPEGServer.publish
        servers = []

        def rec_upload(*a, **k):
            events.append(("upload", sum(e[0] == "upload" for e in events)))
            return upload(*a, **k)

        def rec_publish(self, img, *a, **k):
            events.append(("publish", len(published)))
            published.append(np.array(img))
            out = publish(self, img, *a, **k)
            if not servers:  # fetch the first frame over HTTP while the server runs
                servers.append(self)
                t = threading.Thread(target=fetch, args=(self.url + "frame",), daemon=True)
                t.start()
                t.join(timeout=60)
            return out

        def fetch(url):
            for _ in range(200):
                try:
                    with urllib.request.urlopen(url, timeout=5) as r:
                        fetched.append(r.read())
                        return
                except urllib.error.HTTPError:
                    time.sleep(0.01)

        convert.nv12_device_planes, live.MJPEGServer.publish = rec_upload, rec_publish
        try:
            run("dock --live", ["dock", "--input", str(nv12), "--frames", str(frames),
                                "--live", "--port", "0", "--fps", "60"],
                ("K1", "K2", "K3", "K4"))
        finally:
            convert.nv12_device_planes, live.MJPEGServer.publish = upload, publish
        check_panels("cli dock --live: published frames vs the directly driven panels",
                     published, want)
        ups = [events.index(("upload", i)) for i in range(frames)]
        pubs = [events.index(("publish", i)) for i in range(frames)]
        if pubs != sorted(pubs) or any(ups[i] > pubs[i - 1] for i in range(1, frames)):
            raise AssertionError(f"cli dock --live: not published one frame late: {events}")
        if not fetched:
            raise AssertionError("cli dock --live: no image fetched over HTTP")
        # the server encodes what it serves (PNG, or JPEG where PIL is present):
        # the fetched bytes are one panel's encoding
        hit = next((i for i, p in enumerate(want) if encode_frame(p)[0] == fetched[0]), None)
        if hit is None:
            raise AssertionError("cli dock --live: the fetched image is no frame's panel")
        print(f"cli dock --live: {len(published)} frames published in order, each frame's "
              f"upload before the previous frame's publication; the image fetched over HTTP "
              f"is frame {hit}'s panel", flush=True)
        # P010 (K5)
        run("dock p010", ["dock", "--input", str(p010), "--frames", "3",
                          "--out", str(tmp / "p010.png")], ("K1", "K2", "K3", "K5"))
        src10 = NV12Source(str(p010), w, h, cs=2, bits=10, msb_aligned=True)
        same("dock p010", tmp / "p010.png",
             fanout_dock(list(src10.frames_nv12(3)), src10.nv12_shift))
        info = json.loads(run("info", ["info"], ()))
        if device.type == "cuda" and (
                not info["kernels_built"] or not info["native_runtime"]
                or info["device_name"] != __import__("torch").cuda.get_device_name(0)):
            raise AssertionError(f"cli info: {info}")
        # the installed phase's commands, here in process on the same input:
        # their PNGs are what the installed console script must write
        few, settings = installed_inputs(tmp, h, w)
        pngs = {}
        for name, (args, needs) in installed_commands(few, settings, tmp).items():
            run(name, args, needs)
            pngs[name] = Path(args[args.index("--out") + 1]).read_bytes()
        fp = Dock(roi=ROIConfig(target_scale=2, interleave=1), device=device)
        fp.config.show_focuspeaking = True
        for y, uv in planes[:INSTALLED_FRAMES]:
            fp.push_nv12(y, uv, cs=2)
        want = fp.render(width=512, height=1536)
        same("dock focus peaking, 4 frames", pngs["dock focus peaking, 4 frames"], want)
        if np.array_equal(want, fanout_dock(planes[:INSTALLED_FRAMES])):
            raise AssertionError("cli dock focus peaking: the settings changed nothing")
        sc = Vectorscope(VectorscopeConfig(target_scale=2), device=device)
        for y, uv in planes[:INSTALLED_FRAMES]:
            sc.push_nv12(y, uv, cs=2)
            sc._hub.tick()
        same("scope vectorscope, 4 frames", pngs["scope vectorscope, 4 frames"], sc.render())
    return by_path, pngs


SERVICE_UNIT = "packaging/obs-color-monitor-tpu-torch.service"
UNIT_FRAMES = 8  # frames of the unit's raw RGBA capture (its --frames is 600)


def unit_command(path) -> list:
    """A systemd unit's ``ExecStart`` as an argument list (continued lines
    joined, quoting as the shell's)."""
    import shlex
    from pathlib import Path

    text = Path(path).read_text().replace("\\\n", " ")
    lines = [ln for ln in text.splitlines() if ln.startswith("ExecStart=")]
    if len(lines) != 1:
        raise AssertionError(f"{path}: {len(lines)} ExecStart lines")
    return shlex.split(lines[0][len("ExecStart="):])


def unit_args(args: list, rgba, out, h: int, w: int, device) -> list:
    """The unit's arguments (its script name left out) with its capture and
    panel paths pointed at ``rgba`` and ``out``, its size at ``w``x``h``
    and its device at ``device`` (the unit's own at 4K on a card)."""
    args = list(args)
    for flag, value in (("--input", rgba), ("--out", out), ("--size", f"{w}x{h}"),
                        ("--device", device.type)):
        args[args.index(flag) + 1] = str(value)
    return args


def unit_inputs(tmp, h: int, w: int, frames: int = UNIT_FRAMES):
    """The unit's raw RGBA capture, ``frames`` random frames with alpha-0
    regions, written into ``tmp``; both the in-process and the installed
    run write the same bytes."""
    rgba = tmp / "frames.rgba"
    with open(rgba, "wb") as f:
        for i in range(frames):
            f.write(make_frame(h, w, "random", 2600 + i).tobytes())
    return rgba


def phase_service_unit(device, h=H4K, w=W4K, frames=UNIT_FRAMES) -> tuple:
    """The port's systemd unit (``packaging/obs-color-monitor-tpu-torch.
    service``): its ``ExecStart`` read from the file, the raw RGBA source
    (``pipeline.ingest.RawRGBASource``) on a 4K capture of ``frames``
    frames (the unit reads up to 600; a 4K frame is 33,177,600 bytes), run
    in process (``main([...])``) with the launch counters around it (K1, K2
    and K3 must launch), the PNG equal to the panel of a ``models.Dock``
    driven directly with the same frames.  The installed console script
    runs the same command in :func:`phase_installed_cli`.  Returns (the
    path's counts, the PNG's bytes)."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from obs_color_monitor_tpu_torch import ROIConfig
    from obs_color_monitor_tpu_torch.__main__ import main as cli
    from obs_color_monitor_tpu_torch.models import Dock
    from obs_color_monitor_tpu_torch.pipeline.ingest import RawRGBASource

    argv = unit_command(Path(__file__).resolve().parent / SERVICE_UNIT)
    if (Path(argv[0]).name != "obs-color-monitor-tpu-torch" or argv[1] != "dock"
            or argv[-2:] != ["--device", "cuda"]):
        raise AssertionError(f"service unit: ExecStart {argv}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rgba, png = unit_inputs(tmp, h, w, frames), tmp / "panel.png"
        args = unit_args(argv[1:], rgba, png, h, w, device)
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli(args)
        dt = time.perf_counter() - t0
        if rc != 0 or f"dock: {frames} frames" not in out.getvalue():
            raise AssertionError(f"service unit: exit {rc}\n{out.getvalue()}")
        counts = path_counts("service unit dock rgba", read_counts(), ("K1", "K2", "K3"), device)
        print(f"service unit (in process): {' '.join(args)}: exit 0 in {dt:.2f} s: "
              f"{out.getvalue().strip()}", flush=True)
        d = Dock(roi=ROIConfig(target_scale=2, interleave=1), device=device)
        for f in RawRGBASource(str(rgba), w, h).frames():
            d.push_frame(f)
        want = d.render(width=512, height=1536)
        got = read_png(png)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError("service unit: the PNG differs from the directly driven Dock")
        print(f"service unit: PNG {got.shape[1]}x{got.shape[0]} equal to a directly driven "
              f"Dock's panel on the same {frames} frames", flush=True)
        return {"service unit dock rgba": counts}, png.read_bytes()


INSTALLED_FRAMES = 4  # frames of the installed console script's NV12 file
PORT = "obs_color_monitor_tpu_torch"


def installed_inputs(tmp, h: int, w: int) -> tuple:
    """The installed-route commands' inputs, written into ``tmp``: a 4K
    NV12 file of INSTALLED_FRAMES frames (the CLI phase's first ones) and
    dock settings that show focus peaking.  Both phases write the same
    bytes."""
    nv12, settings = tmp / "few.nv12", tmp / "focus_peaking.json"
    with open(nv12, "wb") as f:
        for b in nv12_buffers(h, w, INSTALLED_FRAMES, 1500):
            f.write(b.tobytes())
    settings.write_text(json.dumps({"focuspeaking-shown": True}))
    return nv12, settings


def installed_commands(nv12, settings, out) -> dict:
    """name -> (CLI arguments but --size and --device, the kernels each
    must launch): the dock with focus peaking (K4, K1, K2, K3) and the
    vectorscope (K4, K1, K7), writing PNGs into ``out``."""
    io = ["--input", str(nv12), "--frames", str(INSTALLED_FRAMES)]
    return {
        "dock focus peaking, 4 frames": (["dock", *io, "--load-settings", str(settings), "--out",
                                str(out / "dock_focus_peaking.png")], ("K1", "K2", "K3", "K4")),
        "scope vectorscope, 4 frames": (["scope", "vectorscope", *io, "--out",
                               str(out / "scope_vectorscope.png")], ("K1", "K4", "K7")),
    }


def tree_state(root) -> dict:
    """Every file and directory under ``root``: relative path -> (mode,
    sha256 of a file's bytes)."""
    import hashlib

    state = {}
    for p in sorted(root.rglob("*")):
        digest = hashlib.sha256(p.read_bytes()).hexdigest() if p.is_file() else None
        state[str(p.relative_to(root))] = (p.stat().st_mode, digest)
    return state


def set_writable(root, on: bool) -> None:
    """Give every file and directory under ``root`` (itself included) its
    owner's write bit, or take every write bit away."""
    import os

    for p in [root, *root.rglob("*")]:
        if p.is_symlink():
            continue
        mode = p.stat().st_mode
        os.chmod(p, mode | 0o200 if on else mode & ~0o222)


def lay_out_package(repo, root) -> tuple:
    """The package laid out as its wheel installs it, in ``root/site``:
    ``pip wheel --no-deps --no-build-isolation --no-index`` of a copy of
    the project's files, then ``pip install --no-deps --no-index --target``
    (the console script lands in ``site/bin``).  Raises where the Python
    lacks pip or setuptools.  Returns (the layout, the wheel's name)."""
    import importlib.util
    import os
    import shutil

    site, stage, wheels = root / "site", root / "stage", root / "wheels"
    skip = shutil.ignore_patterns("_build", "__pycache__", "*.pyc", "*.so")
    missing = [m for m in ("pip", "setuptools") if not importlib.util.find_spec(m)]
    if missing:
        raise AssertionError(f"installed: cannot build the wheel, {missing} missing")
    for name in (PORT, "obs_color_monitor_tpu"):
        shutil.copytree(repo / name, stage / name, ignore=skip)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(repo / name, stage / name)
    env = {**os.environ, "PIP_CONFIG_FILE": os.devnull, "PIP_NO_INDEX": "1",
           "PIP_DISABLE_PIP_VERSION_CHECK": "1", "PIP_NO_INPUT": "1"}

    def pip(*argv):
        p = subprocess.run([sys.executable, "-m", "pip", "--disable-pip-version-check", *argv],
                           cwd=root, env=env, capture_output=True, text=True, timeout=300)
        if p.returncode != 0:
            raise AssertionError(f"pip {argv[0]}: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                                 f"{p.stderr[-3000:]}")

    pip("wheel", "--no-deps", "--no-build-isolation", "--no-index", "-w", str(wheels), str(stage))
    whl = sorted(wheels.glob("*.whl"))
    pip("install", "--no-deps", "--no-index", "--target", str(site), str(whl[0]))
    return site, whl[0].name


def phase_installed_cli(device, pngs: dict, h=H4K, w=W4K, unit_png: bytes | None = None) -> None:
    """The console script of the installed package, on ``device``.  The
    package is laid out as its wheel installs it (:func:`lay_out_package`)
    outside the repository and made read-only; fresh processes, started in
    an empty directory with only that layout on ``PYTHONPATH`` and a fresh
    ``XDG_CACHE_HOME``, build the kernels (timed), then run ``info``, the
    dock with focus peaking and the vectorscope on a 4K NV12 file (the
    console script pip made), each to exit 0.
    The package imported is the layout's; the kernels are built into the
    cache from the installed sources, with the tree's source hash; the
    layout is unchanged after the runs; no process imported ``jax`` or
    ``obs_color_monitor_tpu``; each PNG equals the in-process CLI phase's
    byte for byte (``pngs``); ``info`` reports whether the native runtime
    is active.  With ``unit_png``, the service unit's command
    (:func:`phase_service_unit`) runs on the console script too, its PNG
    equal byte for byte to ``unit_png``."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from obs_color_monitor_tpu_torch import _kernels

    repo = Path(__file__).resolve().parent
    root = Path(tempfile.mkdtemp(prefix="ocm_installed_"))
    try:
        cache, work = root / "cache", root / "work"
        cache.mkdir()
        work.mkdir()
        t0 = time.perf_counter()
        site, wheel = lay_out_package(repo, root)
        print(f"installed: laid out in {time.perf_counter() - t0:.2f} s by pip wheel + pip "
              f"install --target ({wheel})", flush=True)
        set_writable(site, False)
        before = tree_state(site)
        few, settings = installed_inputs(work, h, w)
        env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
        env.update(PYTHONPATH=str(site), XDG_CACHE_HOME=str(cache), PYTHONDONTWRITEBYTECODE="1",
                   PYTHONNOUSERSITE="1")
        script = site / "bin" / "obs-color-monitor-tpu-torch"
        if not script.exists():
            raise AssertionError(f"installed: pip made no console script {script}")
        size = ["--size", f"{w}x{h}", "--device", device.type]

        def run(name, argv):
            """One fresh process; raise unless it exits 0 without importing
            JAX or the JAX package.  Returns (stdout, seconds)."""
            t = time.perf_counter()
            p = subprocess.run([sys.executable, "-X", "importtime", *argv], cwd=work, env=env,
                               capture_output=True, text=True, timeout=600)
            dt = time.perf_counter() - t
            imports = [line.split("|")[-1].strip() for line in p.stderr.splitlines()
                       if line.startswith("import time:")]
            errors = "\n".join(ln for ln in p.stderr.splitlines()
                               if not ln.startswith("import time:"))
            if p.returncode != 0:
                raise AssertionError(f"installed {name}: exit {p.returncode}\n"
                                     f"{p.stdout[-3000:]}\n{errors[-3000:]}")
            loaded = sorted(m for m in imports if m.split(".")[0] in ("jax", "obs_color_monitor_tpu"))
            if loaded:
                raise AssertionError(f"installed {name} imported {loaded}")
            print(f"installed {name}: exit 0 in {dt:.2f} s ({len(imports)} modules imported, "
                  "none of jax or obs_color_monitor_tpu)", flush=True)
            return p.stdout, dt

        # the package the processes import, and (on a card) the kernels
        # built from its sources, timed
        code = ("import json, time; import obs_color_monitor_tpu_torch as p; "
                "from obs_color_monitor_tpu_torch import _kernels as k; "
                f"t0 = time.perf_counter(); lib = k.build() if {device.type == 'cuda'} else None; "
                "print(json.dumps({'package': p.__file__, 'csrc': str(k.CSRC), "
                "'library': lib and str(lib), 'hash': k.source_hash(), "
                "'seconds': time.perf_counter() - t0}))")
        out, _ = run("kernel build", ["-c", code])
        built = json.loads(out.strip().splitlines()[-1])
        if not (Path(built["package"]).is_relative_to(site)
                and Path(built["csrc"]).is_relative_to(site)):
            raise AssertionError(f"installed: the package imported is not the layout's: {built}")
        print(f"installed package: {built['package']}", flush=True)
        if device.type == "cuda":
            lib = Path(built["library"])
            print(f"installed kernel build: nvcc {built['seconds']:.2f} s into {lib}", flush=True)
            if (lib.parent != cache / PORT or not lib.exists()
                    or built["hash"] != _kernels.source_hash()
                    or lib.name != f"libocm_kernels_{_kernels.source_hash()}.so"):
                raise AssertionError(f"installed: the kernels were not built into the cache "
                                     f"from the tree's sources: {built}, tree hash "
                                     f"{_kernels.source_hash()}")
        out, _ = run("info", ["-m", PORT, "info", "--device", device.type])
        info = json.loads(out)
        print(f"installed info: native_runtime {info['native_runtime']}, kernels_built "
              f"{info['kernels_built']}", flush=True)
        if device.type == "cuda" and not info["kernels_built"]:
            raise AssertionError(f"installed info: {info}")
        for name, (args, _) in installed_commands(few, settings, work).items():
            run(f"{name} ({script.name})", [str(script)] + args + size)
            got = Path(args[args.index("--out") + 1]).read_bytes()
            if got != pngs[name]:
                raise AssertionError(f"installed {name}: the PNG differs from the in-process "
                                     "CLI's")
            print(f"installed {name}: PNG equal byte for byte to the in-process CLI's", flush=True)
        if unit_png is not None:
            argv = unit_command(repo / SERVICE_UNIT)
            rgba, png = unit_inputs(work, h, w), work / "panel.png"
            run(f"service unit dock rgba ({script.name})",
                [str(script)] + unit_args(argv[1:], rgba, png, h, w, device))
            if png.read_bytes() != unit_png:
                raise AssertionError("installed service unit: the PNG differs from the "
                                     "in-process run's")
            print("installed service unit: PNG equal byte for byte to the in-process run's",
                  flush=True)
        after = tree_state(site)
        if after != before or (site / PORT / "_build").exists():
            changed = sorted(set(before.items()) ^ set(after.items()))
            raise AssertionError(f"installed: the layout changed: {changed[:10]}")
        print(f"installed: layout unchanged ({len(after)} entries), read-only", flush=True)
    finally:
        set_writable(root, True)
        shutil.rmtree(root, ignore_errors=True)


KERNELS = [  # id, wrapper, source, TPU kernel it replaces, timing key, library key
    ("K1", "frame_pass", "frame_pipeline.cu", "ops/pallas_pipeline.py:149", "k1_random", None),
    ("K2", "vs_wv_counts", "scope_stats.cu", "ops/pallas_stats.py:315", "k2_random",
     "k2_library_random"),
    ("K3", "fused_overlays_planes", "fused_overlays.cu", "ops/pallas_overlays.py:173", "k3",
     None),
    ("K4", "nv12_decode", "nv12_decode.cu", "ops/pallas_convert.py:60", "k4", None),
    ("K5", "nv12_16_decode", "nv12_decode.cu", "ops/pallas_convert.py:88", "k5", None),
    ("K6", "vs_wv_counts (both kernels: a static-rect crop, the mesh paths)", "scope_stats.cu",
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
# the wrapper counts of calls in the fast form (K9's are its two wrappers')
FAST = {"K1": ("K1 vec",), "K2": ("K2 vec",), "K3": ("K3 vec",), "K9": ("K9 vec",)}
RECT_MODE = {"K2": ("k2_rect", "k2_rect_library"), "K3": ("k3_rect", None)}
# the batched form: its timing key, batch size and bound key
BATCHED = {"K1": ("k1_b4", 4, "K1 b4"), "K2": ("k2_b4", 4, "K2 b4"), "K4": ("k4_b2", 2, "K4 b2"),
           "K5": ("k5_b2", 2, "K5 b2")}


def kernel_line(launches: dict, by_path: dict, err: dict, t: dict, bounds: dict,
                dev: dict) -> list:
    """The per-kernel entries of the JSON line: launches summed over the
    main paths, the error against the plain version, event and device
    times, bounds and the library call's time."""
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
        if tkey in dev:
            entry["device_ms"], entry["device_span_ms"], entry["graph_ms"] = dev[tkey]
        if kid in FAST:
            # calls in the 16-byte load / cp.async form over the main paths
            entry["fast_launches"] = sum(launches.get(f, 0) for f in FAST[kid])
        if kid == "K1":
            entry.update({
                "scale_only_ms": t["k1_scale_random"],
                "scale_only_plain_ms": t["k1_scale_plain_random"],
                "scale_only_device_ms": dev["k1_scale_random"][0],
                "scale_only_graph_ms": dev["k1_scale_random"][2],
                "scale_only_bound_ms": bounds["K1 scale"][0],
            })
        if kid == "K3":
            entry.update({
                "cold_ms": t["k3_cold"], "fullres_ms": t["k3_fullres"],
                "fullres_device_ms": dev["k3_fullres"][0], "fullres_graph_ms": dev["k3_fullres"][2],
                "fullres_cold_ms": t["k3_fullres_cold"], "fullres_bound_ms": bounds["K3 full-res"][0],
                "rect_cold_ms": t["k3_rect_cold"],
                "one_output_ms": t["k3_fp"], "one_output_graph_ms": dev["k3_fp"][2],
                "one_output_cold_ms": t["k3_fp_cold"],
                "one_output_bound_ms": bounds["K3 one output"][0],
            })
        if kid == "K6":
            entry.update({
                "4k_scale1_ms": t["k6_4k"], "4k_scale1_plain_ms": t["k6_4k_plain"],
                "4k_scale1_library_ms": t["k6_4k_library"],
                "4k_scale1_device_ms": dev["k6_4k"][0], "4k_scale1_graph_ms": dev["k6_4k"][2],
                "4k_scale1_bound_ms": bounds["K6 4K"][0], "4k_scale1_bound_by": bounds["K6 4K"][1],
            })
        if kid == "K2":
            entry.update({"flat_ms": t["k2_flat"], "flat_device_ms": dev["k2_flat"][0],
                          "flat_device_span_ms": dev["k2_flat"][1],
                          "flat_graph_ms": dev["k2_flat"][2]})
        if kid in SOURCES:
            entry["sources"] = [csrc + f for f in SOURCES[kid]]
        if kid in BATCHED:
            bkey, b, bb = BATCHED[kid]
            entry["batched"] = {
                "B": b, "ms": t[bkey], "device_ms": dev[bkey][0], "graph_ms": dev[bkey][2],
                "bound_ms": bounds[bb][0], "bound_by": bounds[bb][1],
                "library_ms": t.get(bkey + "_library"),
                "launches": sum(c.get(kid, 0) for p, c in by_path.items()
                                if p.startswith("batched")),
            }
        if kid in RECT_MODE:
            rkey, rlib = RECT_MODE[kid]
            entry.update({
                "rect_device_ms": dev[rkey][0], "rect_device_span_ms": dev[rkey][1],
                "rect_graph_ms": dev[rkey][2],
                "rect_launches": launches[f"{kid} rect"],
                "rect_ms": t[rkey], "rect_plain_ms": t[rkey + "_plain"],
                "rect_bound_ms": bounds[f"{kid} rect"][0],
                "rect_library_ms": t[rlib] if rlib else None,
            })
        kernels.append(entry)
    return kernels


def main() -> int:
    t_start = time.perf_counter()
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
    phase_stats_alignment(device, err)
    torch.cuda.synchronize()
    phase_rect_kernels(device, err)
    phase_ingest(device, err)
    torch.cuda.synchronize()
    by_path = {**phase_main_path(device), **phase_dock_paths(device),
               **phase_ingest_path(device), **phase_dynamic_dock(device),
               **phase_stream_dock(device), **phase_captured(device),
               **phase_host_args(device, card),
               **phase_scope_apply(device), **phase_analyze_keywords(device),
               **phase_batched(device), **phase_driver_dock(device)}
    cli_counts, cli_pngs = phase_cli(device)
    by_path.update(cli_counts)
    unit_counts, unit_png = phase_service_unit(device)
    by_path.update(unit_counts)
    phase_installed_cli(device, cli_pngs, unit_png=unit_png)
    mesh_counts, _ = phase_mesh(device, card)
    by_path.update(mesh_counts)
    phase_golden(device)
    t, bounds, dev = phase_timing(device, card)
    phase_profile(device, card)
    by_path.update(phase_driver_soak(device, card))
    launches: dict = {}
    for counts in by_path.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    loaded = sorted(m for m in sys.modules if m in ("jax", "obs_color_monitor_tpu")
                    or m.startswith(("jax.", "obs_color_monitor_tpu.")))
    if loaded:
        raise AssertionError(f"the port loaded {loaded}")

    kernels = kernel_line(launches, by_path, err, t, bounds, dev)
    print(f"chip_smoke: total wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
