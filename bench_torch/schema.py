"""The benchmark's self-check: ``python3 -m bench_torch.schema``.

It checks ``BENCHMARK.json`` against the rules its consumers hold it to:
names and units of the allowed characters and lengths, each metric's
``workloads`` and ``moves`` naming what exists, every cell reporting
``setup_s``, another end-to-end metric, a per-layer metric and the
end-to-end metric each of its per-layer metrics moves, the configuration,
traffic and reader files each name points to, each configuration file's
keys (``serve.config_problems``), and the bounds.  A run calls
:func:`check_modules` at its end: no module of JAX or of the JAX package
may have been loaded.
"""

from __future__ import annotations

import json
import re
import sys

from . import serve, spec
from .traffic import generator

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
FORBIDDEN = ("jax", "obs_color_monitor_tpu", "benchmarks")


def check_modules() -> None:
    """Raise if JAX, the JAX package or the JAX benchmarks were imported."""
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if bad:
        raise RuntimeError(f"modules the port's benchmark must not load: {bad[:5]}")


def problems(bench: dict) -> list:
    out = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(bench) != keys:
        out.append(f"top-level keys {sorted(bench)} != {sorted(keys)}")
    for p in bench["paths"]:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    if not 1 <= len(bench["command"]) <= 32 or not all(LINE.match(w) for w in bench["command"]):
        out.append("command")
    if not (isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51):
        out.append("run_seconds")
    names = {}
    for kind, fields in (("configs", {"name", "source", "file", "reduced", "why"}),
                         ("workloads", {"name", "config", "traffic", "chips", "why"}),
                         ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                         ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in bench[kind]:
            extra = set(e) - fields - ({"workloads"} if kind in ("end_to_end", "per_layer")
                                       else set())
            if set(fields) - set(e) or extra:
                out.append(f"{kind} {e.get('name')}: keys {sorted(e)}")
            if not NAME.match(e["name"]):
                out.append(f"{kind} name {e['name']!r}")
            group = "metric" if kind in ("end_to_end", "per_layer") else kind
            if e["name"] in names.setdefault(group, set()):
                out.append(f"duplicate {group} name {e['name']}")
            names[group].add(e["name"])
            for k in ("why", "layer", "source"):
                if k in e and not LINE.match(str(e[k])):
                    out.append(f"{kind} {e['name']}: {k} is not one line of 1-200 characters")
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"{kind} {e['name']}: unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"{kind} {e['name']}: better")
    cells = {w["name"]: w for w in bench["workloads"]}
    for c in bench["configs"]:
        if not any(w["config"] == c["name"] for w in bench["workloads"]):
            out.append(f"config {c['name']} has no cell")
        path = spec.ROOT / c["file"]
        if not path.is_file() or not any(c["file"].startswith(p + "/") for p in bench["paths"]):
            out.append(f"config file {c['file']}")
        else:
            data = json.loads(path.read_text())
            if data.get("reduced") != c["reduced"]:
                out.append(f"config {c['name']}: reduced differs from its file's")
            out += [f"config {c['name']}: {b}" for b in serve.config_problems(data)]
        if len(c["reduced"]) > 16 or not all(NAME.match(k) for k in c["reduced"]):
            out.append(f"config {c['name']}: reduced")
    pairs = set()
    for w in cells.values():
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"cell {w['name']}: its config and traffic pair repeats")
        pairs.add((w["config"], w["traffic"]))
        if w["config"] not in names["configs"] or w["chips"] not in (1, 4):
            out.append(f"cell {w['name']}: config or chips")
        if not NAME.match(w["traffic"]):
            out.append(f"cell {w['name']}: traffic name")
        try:
            generator.load(w["traffic"])
        except (OSError, ValueError, KeyError) as e:
            out.append(f"cell {w['name']}: {e}")
    if sum(w["chips"] == 4 for w in cells.values()) > max(1, len(cells) // 4):
        out.append("too many four-chip cells")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: an end-to-end metric's source")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound outside [0.01, 0.25]")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves {m['moves']!r}, not an end-to-end metric")
        if m["source"] not in ("device_trace", "program_span", "program_counter", "host_clock"):
            out.append(f"{m['name']}: source")
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            for w in m.get("workloads", []):
                if w not in cells:
                    out.append(f"{m['name']}: workload {w} does not exist")
            if not spec.reader_path(m["name"]).is_file():
                out.append(f"{m['name']}: no reader under metrics/")
    for w in cells:
        rep = {m["name"] for m in spec.metrics_for(bench, w, "end_to_end")}
        layer = spec.metrics_for(bench, w, "per_layer")
        if "setup_s" not in rep or len(rep) < 2 or not layer:
            out.append(f"cell {w}: needs setup_s, another end-to-end metric and a per-layer one")
        for m in layer:
            if m["moves"] not in rep:
                out.append(f"cell {w}: {m['name']} moves {m['moves']}, which it does not report")
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    if len(json.dumps(bench)) > 64 * 1024:
        out.append("BENCHMARK.json over 64 KiB")
    return out


def main() -> int:
    bad = problems(spec.load_benchmark())
    for b in bad:
        print(b, file=sys.stderr)
    print("BENCHMARK.json: " + ("ok" if not bad else f"{len(bad)} problems"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
