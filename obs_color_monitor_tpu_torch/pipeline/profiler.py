"""Profiling probes (replaces the reference's ENABLE_PROFILE hooks).

Counterpart of ``obs_color_monitor_tpu/pipeline/profiler.py``: the same
probe names and the same ``enable/reset/summary/probe`` API.  The reference
wraps hot sections with the libobs profiler when compiled with
ENABLE_PROFILE (reference CMakeLists.txt:15, src/common.c:10-21); here an
enabled probe is a ``torch.profiler.record_function`` span (plus an NVTX
range when a CUDA device is present) and a host-side timing counter,
switchable at runtime.  ``start_trace``/``stop_trace`` wrap a
``torch.profiler.profile`` of the host and, where present, the CUDA device,
and write a Chrome trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import torch

_enabled = False
_stats: dict[str, list[float]] = defaultdict(list)
_lock = threading.Lock()
_trace: Optional[tuple[torch.profiler.profile, Path]] = None


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    with _lock:
        _stats.clear()


def summary() -> dict[str, dict[str, float]]:
    """Per-probe count/total/mean seconds."""
    with _lock:
        return {
            k: {
                "count": len(v),
                "total_s": sum(v),
                "mean_s": sum(v) / len(v) if v else 0.0,
            }
            for k, v in _stats.items()
        }


@contextlib.contextmanager
def probe(name: str):
    """Named probe (probe names mirror the reference's:
    'render_target', 'convert_yuv', 'draw_vectorscope', ...)."""
    if not _enabled:
        yield
        return
    nvtx = torch.cuda.is_available()
    t0 = time.perf_counter()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    dt = time.perf_counter() - t0
    with _lock:
        _stats[name].append(dt)


def start_trace(log_dir: str) -> None:
    """Start a trace of the host and the CUDA device (view the Chrome trace
    that :func:`stop_trace` writes to ``log_dir`` in chrome://tracing or
    Perfetto)."""
    global _trace
    if _trace is not None:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace = (prof, Path(log_dir))


def stop_trace() -> Path:
    """Stop the trace and write it; returns the trace file's path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running")
    (prof, log_dir), _trace = _trace, None
    prof.stop()
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    return path
