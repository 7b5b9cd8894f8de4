"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 -m bench_torch.run --workload uhd60.settled --seed 7 --seconds 20 --trace 0

from the repository's root, on a machine with the cell's CUDA cards.  A run
makes its frames from ``--seed``, builds its docks and drivers, warms up
the cell's own shapes (every graph capture included), drives the cell for
``--seconds``, checks a seeded sample of the panels and statistics against
the plain reference, and prints one JSON line last: ``--trace 0`` the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics.  The
profiler traces the window of a ``--trace 1`` run and of any run whose
cell reports an end-to-end metric read from the device trace.  Without the
cards it fails and prints no result.

    python3 -m bench_torch.run --rehearse

runs every cell at a tiny frame size on the CPU through the program's
plain versions, checks ``correct`` and the line's shape, and reads no
metric: the rehearsal of a run on the card.

    python3 -m bench_torch.run --workload uhd60.settled --control --seeds 7,8,9

prints the correctness control's numbers: the reference with its capture
computed in bfloat16, put in the program's place on the cell's frames.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from . import check, schema, serve, spec  # noqa: E402
from .traffic import generator  # noqa: E402

NOT_MEASURED = "not measured"
REHEARSE_SIZE = (72, 128)  # frame height, width
REHEARSE_FPS = 4


class Run:
    """A finished run, as the metric readers see it."""

    def __init__(self, cell, window: dict, t_start: float):
        self.cfg, self.traffic = cell.cfg, cell.t
        self.window, self.t_start = window, t_start
        self.frames = cell.window_records()
        self.staging = window["staging"]
        self.trace = window["trace"]


def breakdown(run: Run) -> dict:
    """The traced slice's device operations by time, and its idle time by
    what the host was doing: the workers issuing a frame, the sink waiting
    for a panel, a producer copying a frame in, or none of them."""
    from .arith import covering, gaps
    from .trace import short_name

    tr = run.trace
    ops: dict = {}
    for name, s, e in tr["ops"]:
        k = short_name(name)
        ops[k] = ops.get(k, 0.0) + (e - s)
    spans = {"worker issuing (Dock.push_nv12, render_async)": [],
             "sink waiting for the panel's copy": [],
             "producer copying a frame in (push_nv12)": []}
    labels = list(spans)
    for f in run.frames:
        for label, a, b in ((labels[0], f.t_issue0, f.t_issue1), (labels[1], f.t_issue1, f.t_landed),
                            (labels[2], f.t_push, f.t_pushed)):
            if a is not None and b is not None:
                spans[label].append((a, b))
    covers = {k: covering(v) for k, v in spans.items()}
    idle: dict = {}
    for a, b in gaps([(s, e) for _, s, e in tr["ops"]], tr["lo"], tr["hi"]):
        mid = (a + b) / 2
        label = next((k for k in labels if covers[k](mid)), "no frame in flight on the host")
        idle[label] = idle.get(label, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def dump_frames(cell, t0: float, path: str) -> None:
    """Every window frame's times, in seconds from the window's start, one
    JSON object a line (a diagnostic: where a tail comes from)."""
    keys = ("due", "t_push", "t_pushed", "t_issue0", "t_issue1", "t_landed")
    with open(path, "w") as f:
        for r in cell.window_records():
            row = {k: None if getattr(r, k) is None else getattr(r, k) - t0 for k in keys}
            row.update(stream=r.stream, index=r.index, consumed=r.consumed, dropped=r.dropped)
            f.write(json.dumps(row) + "\n")


def measure(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
            cfg=None, traffic=None, frames_out=None) -> dict:
    """One run of ``cell``; the result line as a dict and the compared
    numbers (``check.check``)."""
    cfg = cfg or spec.config(bench, cell["config"])
    traffic = traffic or generator.load(cell["traffic"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    c = serve.Cell(cfg, traffic, seed, dev)
    c.start()
    try:
        c.warmup()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        tracer = None
        from_trace = any(m["source"] == "device_trace"
                         for m in spec.metrics_for(bench, cell["name"], "end_to_end"))
        if on_card and (trace or from_trace):
            from .trace import Tracer

            tracer = Tracer(dev)
        window = c.window(seconds, tracer)
    finally:
        c.stop()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    if frames_out:
        dump_frames(c, window["t0"], frames_out)
    run = Run(c, window, T_START)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], kind):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": None,
        "attempted": len(run.frames),
        "failed": sum(1 for f in run.frames if f.t_landed is None),
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell["chips"],
                   "memory_peak_bytes": peak} if on_card else {"platform": NOT_MEASURED},
    }
    if trace and run.trace is not None:
        from .arith import busy

        tr = run.trace
        result["device"]["busy_s"] = busy((s, e) for _, s, e in tr["ops"])
        result["device"]["window_s"] = tr["hi"] - tr["lo"]
        result["breakdown"] = breakdown(run)
    # the program's state is freed before the reference runs on the card
    for s in c.streams:
        s.dock = s.driver = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.check(c, window, dev)
    t_check = time.perf_counter() - t_check
    nums = verdict["numbers"]
    result["correct"] = all(v <= lim for v, lim in nums.values())
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in nums.items()}
    print(f"checked {verdict['checked']} of {verdict['sampled']} sampled frames "
          f"in {t_check:.1f} s: {verdict['analysed']} analysed, {verdict['skipped']} skipped; "
          f"refused on a full queue and checked in the next frame's place: "
          f"{verdict['refused']}, with no frame left to take it: {verdict['unplaced']}",
          file=sys.stderr, flush=True)
    return result


def emit(result: dict) -> None:
    """The compared numbers last on stderr, the result line last on stdout."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def tiny(bench: dict, cell: dict) -> tuple:
    """A cell's configuration and traffic cut for the CPU: REHEARSE_SIZE
    frames, three to a stream's pool, at REHEARSE_FPS."""
    cfg = spec.config(bench, cell["config"])
    traffic = generator.load(cell["traffic"])
    h, w = REHEARSE_SIZE
    cfg = {**cfg, "frame": {**cfg["frame"], "height": h, "width": w}}
    traffic = {**traffic, "pool_bytes": 3 * cfg["streams"] * h * w * 3 // 2,
               "warmup_frames": min(traffic["warmup_frames"], 12),
               "fps": REHEARSE_FPS}
    return cfg, traffic


def rehearse(bench: dict) -> int:
    """Every cell at a tiny frame size on the CPU: correctness and the
    line's shape; every measured value reads "not measured"."""
    torch.set_num_threads(2)
    ok = True
    for cell in bench["workloads"]:
        cfg, traffic = tiny(bench, cell)
        for trace in (0, 1):
            res = measure(bench, cell, 1, 3.0, bool(trace), "cpu", cfg, traffic)
            want = {m["name"] for m in spec.metrics_for(bench, cell["name"],
                                                        "per_layer" if trace else "end_to_end")}
            card_only = {"copy_ms", "card_ms", "step_roofline", "idle_share", "stats_ms"}
            missing = {m for m in want - set(res["metrics"])
                       if m.split(".")[0] not in card_only}
            for m in res["metrics"].values():
                m["value"] = NOT_MEASURED
            good = res["correct"] and not missing and list(res)[-1] == "checks"
            ok &= good
            print(f"rehearsal {cell['name']} trace {trace}: "
                  f"{'ok' if good else 'FAILED'}; metrics not read: {sorted(missing)}",
                  file=sys.stderr, flush=True)
            emit(res)
    schema.check_modules()
    return 0 if ok else 1


def control(bench: dict, cell: dict, seed: int) -> dict:
    """The bfloat16-capture reference in the program's place: the cell's
    frames, due in order with none dropped, compared as a run compares."""
    cfg = spec.config(bench, cell["config"])
    traffic = generator.load(cell["traffic"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    seconds = bench["run_seconds"]
    c = serve.Cell(cfg, traffic, seed, dev, docks=False)
    n_plan = generator.plan(traffic, seconds)
    want, got = check.Expect(c, dev), check.Expect(c, dev, torch.bfloat16)
    tms = check.clock(traffic["warmup_frames"] + n_plan)
    nums = dict.fromkeys(("panel_bytes_off", "capture_bytes_off", "counts_off"), 0)
    for s in range(cfg["streams"]):
        n_pool = len(c.pools[s])
        pools = [k % n_pool for k in range(traffic["warmup_frames"])] + [
            i % n_pool for i in range(n_plan)]
        for i in sorted(generator.sample(traffic, seed, s, cfg["streams"], n_plan)):
            j = traffic["warmup_frames"] + i
            args = (s, pools, j, tms[j])
            panel, f = got.of(*args)
            for k, v in check.compare(want.of(*args), panel.cpu().numpy(),
                                      (f.capture.permute(2, 0, 1), f.vs, f.wv, f.hi),
                                      dev).items():
                nums[k] += v
    return nums


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", help="the control's seeds, comma-separated")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--frames-out", help="write every window frame's times to this file")
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    if args.rehearse:
        return rehearse(bench)
    cell = spec.workload(bench, args.workload)
    if args.control:
        for seed in (args.seeds.split(",") if args.seeds else [args.seed]):
            nums = control(bench, cell, int(seed))
            print(f"control {cell['name']} seed {seed}: "
                  + ", ".join(f"{k} {v} (limit 0)" for k, v in nums.items()), flush=True)
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seconds = args.seconds if args.seconds is not None else bench["run_seconds"]
    result = measure(bench, cell, args.seed, seconds, bool(args.trace), "cuda",
                     frames_out=args.frames_out)
    schema.check_modules()
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
