#!/usr/bin/env python3
"""Device times of kernels K1, K2 and K3 at the main paths' shapes, for
comparing checkouts of the repository on one CUDA card.

    python3 kernel_times.py [CHECKOUT ...]

Each checkout (default: this one) runs in a process of its own, in the
order given, and imports its own package; the timing helpers are this
checkout's ``chip_smoke``.  List a parent and a change as ``parent change
change parent`` so that a drift of the card falls on both.  Per checkout it
prints the card's name and power limit, then for each key the CUDA-event
time per call (the host's issue time included), the CUDA-graph replay time
(the host left out, overlapping kernels counted once) and the profiler's
device time split by kernel name.  The keys: K1 at 3840x2160 packed, scale
2, with overlays (``k1_overlay_scale``) and without (``k1_scale``); K2 on
the 1920x1080 capture of a random and a flat 4K frame, both counts
(``k2_random``, ``k2_flat``), with the ROI rect (``k2_rect``), each count
alone (``k2_vs``, ``k2_wv``), and each alone with an empty rect, which
counts nothing and leaves the fixed costs (``k2_vs_empty``,
``k2_wv_empty``); K3 with packed output on that capture, all three
overlays (``k3``), with the ROI rect (``k3_rect``) and focus peaking alone
(``k3_fp``), and on the 4K frame (``k3_fullres``).  The K3 keys are also
timed once per call with a cold L2 (``cold time``: a 256 MiB buffer
written before each call, CUDA events around the call alone).  Needs a
CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys


def inner(root: str) -> None:
    import chip_smoke as cs  # this checkout's helpers, whatever the root

    sys.path.insert(0, root)
    import torch

    from obs_color_monitor_tpu_torch.ops import fused_overlays as fo
    from obs_color_monitor_tpu_torch.ops import overlays as ov
    from obs_color_monitor_tpu_torch.ops import pipeline as pl
    from obs_color_monitor_tpu_torch.ops import scope_stats as ss

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"checkout {root}: {card}", flush=True)
    fns = {}
    # the zebra clock as the checkout's K1 and K3 take it: a float32 in
    # device memory where they read it there (a float would add a fill
    # launch to every timed call), else a float
    tm = torch.ones((), dtype=torch.float32, device=dev) if hasattr(ov, "clock_tensor") else 1.0
    kw = dict(packed=True, cs=2, scale=2, **cs.OV_ARGS)
    x = cs.as_input(cs.make_frame(cs.H4K, cs.W4K, "random", 3), True, dev)
    fns["k1_overlay_scale"] = lambda: pl.frame_pass(x, tm, **kw)
    fns["k1_scale"] = lambda: pl.frame_pass(x, 1.0, **dict(kw, with_overlays=False))
    roi = torch.tensor(cs.ROI, dtype=torch.int32, device=dev)
    empty = torch.zeros(4, dtype=torch.int32, device=dev)
    for kind in ("random", "flat"):
        f = cs.as_input(cs.make_frame(cs.H4K, cs.W4K, kind, 3), True, dev)
        i = pl.stats_inputs(*pl.frame_pass_reference(f, 1.0, **kw)[:2], False)
        fns[f"k2_{kind}"] = lambda i=i: ss.vs_wv_counts(*i)
        if kind == "random":
            fns["k2_rect"] = lambda i=i: ss.vs_wv_counts(*i, rect=roi)
            fns["k2_vs"] = lambda i=i: ss.vs_wv_counts(*i, need_wv=False)
            fns["k2_wv"] = lambda i=i: ss.vs_wv_counts(*i, need_vs=False)
            fns["k2_vs_empty"] = lambda i=i: ss.vs_wv_counts(*i, need_wv=False, rect=empty)
            fns["k2_wv_empty"] = lambda i=i: ss.vs_wv_counts(*i, need_vs=False, rect=empty)
    cap = pl.frame_pass_reference(x, 1.0, **dict(kw, with_overlays=False))[0]
    full = cs.as_input(cs.make_frame(cs.H4K, cs.W4K, "random", 4), False, dev)
    k3kw = dict(cs.OV_ARGS, packed_out=True)
    k3 = {
        "k3": lambda: fo.fused_overlays_planes(cap, tm, **k3kw),
        "k3_rect": lambda: fo.fused_overlays_planes(cap, tm, rect=roi, **k3kw),
        "k3_fp": lambda: fo.fused_overlays_planes(cap, tm, outputs=(False, False, True),
                                                  **k3kw),
        "k3_fullres": lambda: fo.fused_overlays_planes(full, tm, **k3kw),
    }
    fns.update(k3)
    for k, v in cs.time_ms(fns).items():
        print(f"time {k}: {v:.4f} ms", flush=True)
    for k, v in cs.graph_ms(fns).items():
        print(f"graph time {k}: {v:.4f} ms", flush=True)
    for k, v in cs.cold_ms(k3).items():
        print(f"cold time {k}: {v:.4f} ms", flush=True)
    cs.device_ms(fns, card)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--inner"]:
        inner(argv[1])
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    rc = 0
    for root in argv or [here]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--inner",
                              os.path.abspath(root)], cwd=os.path.abspath(root)).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
