"""Sets of runs of one cell, and the spread of each metric over them.

    python3 -m bench_torch.sets --workload uhd60.settled --seeds 11,12,13,14,15,16 \\
        --sets 2 --seconds 51 --out <directory>

runs the cell once per seed per set, each run a fresh process as a check
runs it (one more run first when ``--prime`` is given: a checkout's first
run builds the kernels), keeps each run's result line in
``<out>/<workload>.jsonl`` (with ``--diag``, each run's frame times
under ``<out>/diag``) and prints, for each metric and set, the median
and the quartile spread (``arith.spread``), and ``correct`` of every run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

from .arith import spread


def one(workload: str, seed: int, seconds: float, trace: int, stem=None) -> dict:
    """One run in a fresh process; with ``stem``, its frame times kept in
    ``<stem>.frames``."""
    cmd = [sys.executable, "-m", "bench_torch.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    if stem is not None:
        cmd += ["--frames-out", f"{stem}.frames"]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = p.stdout.strip().splitlines()
    if p.returncode or not lines:
        return {"seed": seed, "rc": p.returncode, "error": p.stderr[-2000:]}
    res = json.loads(lines[-1])
    res.update(seed=seed, rc=0, stderr=[l for l in p.stderr.splitlines()
                                        if l.startswith(("gc:", "trace:", "checked", "stream"))])
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=20)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--prime", action="store_true")
    p.add_argument("--out", required=True)
    p.add_argument("--diag", action="store_true",
                   help="keep each run's frame times under <out>/diag")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    log = (out / f"{args.workload}.jsonl").open("a")
    diag = None
    if args.diag:
        diag = out / "diag"
        diag.mkdir(exist_ok=True)
    if args.prime:
        r = one(args.workload, seeds[0] + 1, args.seconds, args.trace)
        r["set"] = "prime"
        log.write(json.dumps(r) + "\n")
        print(f"prime: rc {r['rc']} correct {r.get('correct')} "
              f"{ {k: v['value'] for k, v in r.get('metrics', {}).items()} }", flush=True)
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            r = one(args.workload, seed, args.seconds, args.trace,
                    diag / f"{args.workload}.{k}.{seed}" if diag else None)
            r["set"] = k
            log.write(json.dumps(r) + "\n")
            log.flush()
            vals = {m: v["value"] for m, v in r.get("metrics", {}).items()}
            print(f"set {k} seed {seed}: rc {r['rc']} correct {r.get('correct')} "
                  f"attempted {r.get('attempted')} failed {r.get('failed')} {vals} "
                  + (r["error"][-600:] if r["rc"] else "; ".join(r["stderr"])), flush=True)
            runs.append(r)
        sets.append(runs)
    names = sorted({m for runs in sets for r in runs for m in r.get("metrics", {})})
    for m in names:
        for k, runs in enumerate(sets):
            vals = [r["metrics"][m]["value"] for r in runs if m in r.get("metrics", {})]
            if len(vals) >= 2:
                print(f"{args.workload} {m} set {k}: median {statistics.median(vals):.6g} "
                      f"spread {spread(vals):.4%} n {len(vals)} values {vals}", flush=True)
    bad = [r["seed"] for runs in sets for r in runs if r.get("correct") is not True]
    print(f"{args.workload}: runs not correct: {bad}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
