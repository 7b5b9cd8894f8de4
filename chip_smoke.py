#!/usr/bin/env python3
"""Drive the torch port's six-scope step on one CUDA GPU, end to end.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA GPU and exits non-zero without one.  Phases, in order;
any failure raises and the exit code is non-zero:

1. versions, and the card's name and power limit from nvidia-smi;
2. build the CUDA kernels from ``obs_color_monitor_tpu_torch/ops/csrc``
   (printing ptxas' resource use per kernel);
3. each kernel against its plain PyTorch version on the card, over shapes
   (4K and odd sizes), scales 1/2/3/4/8, both component families, BT601 and
   BT709, packed and planar input, and random / flat-grey / colour-bar
   frames with alpha-0 regions: ``torch.equal`` on every output;
4. the main path: ``make_full_step(2160, 3840, scale=2,
   input_format="packed", device="cuda")`` on 8 frames, every field equal
   to the same step run on the CPU; the launch counters of both kernels
   read around that run; one 270x480 frame against the golden model;
5. timing with CUDA events (warm-up, then the median of 25 runs of 10
   back-to-back calls): the step per frame on a random and a flat 4K frame,
   and each kernel beside its plain version at the step's shapes;
6. a torch.profiler window over 10 steps: device time per kernel and the
   device's busy share of the window.

Then one JSON line with the per-kernel results and, as the last line,
``{"ok": true, "device": {...}}``.
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


def as_input(f: np.ndarray, packed: bool, device):
    import torch

    arr = f.view(np.int32)[..., 0] if packed else np.ascontiguousarray(np.moveaxis(f, -1, 0))
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def max_abs_err(a, b) -> int:
    import torch

    if a is None and b is None:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def kernel_cases():
    """Phase-3 cases: (h, w, scale, yuv_data, cs, kind, packed, tm)."""
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


def phase_kernels(device, cases) -> dict:
    """Each kernel vs its plain version on ``device``; returns max errors."""
    import torch
    from obs_color_monitor_tpu_torch.ops import pipeline as pl
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    err = {"K1": 0, "K2": 0}
    for n, (h, w, scale, yuv, cs, kind, packed, tm) in enumerate(cases):
        x = as_input(make_frame(h, w, kind, n), packed, device)
        kw = dict(packed=packed, cs=cs, scale=scale, **OV_ARGS)
        got = pl.frame_pass(x, tm, **kw)
        ref = pl.frame_pass_reference(x, tm, **kw)
        e1 = max(max_abs_err(a, b) for a, b in zip(got, ref))
        inputs = pl.stats_inputs(ref[0], ref[1], yuv)
        vs, wv = ss.vs_wv_counts(*inputs)
        rvs, rwv = ss.vs_wv_counts_reference(*inputs)
        e2 = max(max_abs_err(vs, rvs), max_abs_err(wv, rwv))
        eq1 = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, ref))
        eq2 = torch.equal(vs, rvs) and torch.equal(wv, rwv)
        fam = "yuv" if yuv else "rgb"
        print(f"case {n:2d} {h}x{w} scale {scale} {fam} cs {cs} {kind:6s} "
              f"{'packed' if packed else 'planar'}: K1 equal={eq1} K2 equal={eq2}", flush=True)
        if not (eq1 and eq2):
            raise AssertionError(f"kernel differs from its plain version in case {n}: "
                                 f"K1 max err {e1}, K2 max err {e2}")
        err["K1"] = max(err["K1"], e1)
        err["K2"] = max(err["K2"], e2)
    return err


def phase_main_path(device, h=H4K, w=W4K, frames=STEP_FRAMES) -> dict:
    """The 4K scale-2 packed step on ``device`` vs the CPU; launch counts."""
    import torch
    from obs_color_monitor_tpu_torch import frame_from_numpy, make_full_step
    from obs_color_monitor_tpu_torch.ops.pipeline import frame_pass
    from obs_color_monitor_tpu_torch.ops.scope_stats import vs_wv_counts

    step = make_full_step(h, w, scale=2, input_format="packed", device=device)
    step_cpu = make_full_step(h, w, scale=2, input_format="packed", device="cpu")
    host = [make_frame(h, w, "random", 100 + i).view(np.uint32)[..., 0] for i in range(frames)]
    dev_frames = [frame_from_numpy(f, "packed", device) for f in host]
    if device.type == "cuda":
        torch.cuda.synchronize()
    frame_pass.launches = 0
    vs_wv_counts.launches = 0
    outs = [step(x, i * 0.0667).to_numpy() for i, x in enumerate(dev_frames)]
    launches = {"K1": frame_pass.launches, "K2": vs_wv_counts.launches}
    print(f"main path: {frames} frames {w}x{h} packed scale 2 on {device}; "
          f"launches K1={launches['K1']} K2={launches['K2']}", flush=True)
    for i, f in enumerate(host):
        ref = step_cpu(frame_from_numpy(f, "packed", "cpu"), i * 0.0667).to_numpy()
        for k, v in ref.items():
            got = outs[i][k]
            if got.shape != v.shape or got.dtype != v.dtype or not np.array_equal(got, v):
                raise AssertionError(f"frame {i}: field {k} differs from the CPU step")
        for name in ("vs_counts", "wv_counts", "hi_counts", "zebra"):
            if not np.isfinite(outs[i][name].astype(np.float64)).all():
                raise AssertionError(f"frame {i}: {name} not finite")
    print(f"main path: all {len(ref)} fields equal to the CPU step on {frames} frames",
          flush=True)
    return launches


def phase_golden(device, h=270, w=480) -> None:
    """One small frame through the step on ``device`` vs the golden model."""
    from obs_color_monitor_tpu_torch import frame_from_numpy, make_full_step
    from obs_color_monitor_tpu_torch.spec import Components, FocusPeakingConfig, golden

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


def phase_timing(device, card: str) -> dict:
    from obs_color_monitor_tpu_torch import make_full_step
    from obs_color_monitor_tpu_torch.ops import pipeline as pl
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    step = make_full_step(H4K, W4K, scale=2, input_format="packed", device=device)
    kw = dict(packed=True, cs=2, scale=2, **OV_ARGS)
    fns = {}
    for kind in ("random", "flat"):
        x = as_input(make_frame(H4K, W4K, kind, 3), True, device)
        inputs = pl.stats_inputs(*pl.frame_pass_reference(x, 1.0, **kw)[:2], False)
        fns[f"step_{kind}"] = lambda x=x: step(x, 1.0)
        fns[f"k1_{kind}"] = lambda x=x: pl.frame_pass(x, 1.0, **kw)
        fns[f"k1_plain_{kind}"] = lambda x=x: pl.frame_pass_reference(x, 1.0, **kw)
        fns[f"k2_{kind}"] = lambda i=inputs: ss.vs_wv_counts(*i)
        fns[f"k2_plain_{kind}"] = lambda i=inputs: ss.vs_wv_counts_reference(*i)
    t = time_ms(fns)
    for k, v in t.items():
        print(f"time {k}: {v:.4f} ms  [{card}]", flush=True)
    return t


def phase_profile(device, card: str, steps: int = 10) -> None:
    """Where a 4K step's time goes: torch.profiler over ``steps`` steps;
    device time per kernel name and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from obs_color_monitor_tpu_torch import make_full_step

    step = make_full_step(H4K, W4K, scale=2, input_format="packed", device=device)
    x = as_input(make_frame(H4K, W4K, "random", 3), True, device)
    for _ in range(3):
        step(x, 1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(x, i * 0.0667)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = per_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us()
            rec[1] += 1
    busy = sum(v[0] for v in per_name.values())
    if not per_name:
        print("profile: the profiler recorded no device time", flush=True)
        return
    print(f"profile: {steps} steps, host window {window_us / steps / 1000:.4f} ms/step, "
          f"device busy {busy / steps / 1000:.4f} ms/step "
          f"({100 * busy / window_us:.1f}% of the window), "
          f"{sum(v[1] for v in per_name.values()) // steps} device ops/step  [{card}]",
          flush=True)
    for name, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"profile: {us / steps / 1000:.4f} ms/step  x{n // steps}  {name[:90]}", flush=True)


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

    err = phase_kernels(device, kernel_cases())
    launches = phase_main_path(device)
    if launches["K1"] < 1 or launches["K2"] < 1:
        raise AssertionError(f"the main path did not launch every kernel: {launches}")
    phase_golden(device)
    t = phase_timing(device, card)
    phase_profile(device, card)
    if "jax" in sys.modules:
        raise AssertionError("the port loaded jax")

    kernels = [
        {"name": "frame_pass (K1)", "route": "cuda",
         "source": "obs_color_monitor_tpu_torch/ops/csrc/frame_pipeline.cu",
         "replaces": "obs_color_monitor_tpu/ops/pallas_pipeline.py:149",
         "launches": launches["K1"], "max_abs_err": err["K1"],
         "ms": t["k1_random"], "plain_ms": t["k1_plain_random"]},
        {"name": "vs_wv_counts (K2)", "route": "cuda",
         "source": "obs_color_monitor_tpu_torch/ops/csrc/scope_stats.cu",
         "replaces": "obs_color_monitor_tpu/ops/pallas_stats.py:315",
         "launches": launches["K2"], "max_abs_err": err["K2"],
         "ms": t["k2_random"], "plain_ms": t["k2_plain_random"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
