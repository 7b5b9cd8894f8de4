"""``BENCHMARK.json`` and the files its names point to.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name: ``configs/<config>.json``,
``traffic/<mix>.json`` and ``metrics/<metric>.py``, where a metric's reader
may also serve every metric whose name starts with its own and a dot
(``metrics/copy_ms.py`` would also read ``copy_ms.fps``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those whose ``workloads`` list it, or that have none."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader_path(metric: str) -> Path:
    whole = HERE / "metrics" / f"{metric}.py"
    if whole.is_file():
        return whole
    return HERE / "metrics" / f"{metric.split('.')[0]}.py"


def reader(metric: str):
    """The ``read(run)`` function of a per-layer metric."""
    path = reader_path(metric)
    if not path.is_file():
        raise FileNotFoundError(f"no reader for {metric!r} under metrics/")
    spec = importlib.util.spec_from_file_location(f"bench_torch.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
