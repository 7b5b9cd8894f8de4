"""The device trace of a ``--trace 1`` run.

``torch.profiler`` (CUPTI) records every device operation of every thread
from just before the window opens until it closes; the run reads the
profiler's raw events, not its per-event Python objects, so that a window
of eight streams reads in seconds.  Two marker kernels, issued on a side
stream at known host times, put the device timeline on the host clock, so
each idle stretch of the card can be labelled by what the benchmark's
threads were doing then.
"""

from __future__ import annotations

import re
import sys
import time

import torch

_MARK = "spin_kernel"  # torch.cuda._sleep's kernel


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces and template arguments."""
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", name)
    base = m.group(1) if m and not name.startswith("Memcpy") else name
    return base[:80]


def _experimental():
    """Profile every thread (the workers and producers, not only the one that
    starts the profiler) and skip the per-event Python objects, as far as
    this torch offers either."""
    from torch._C._profiler import _ExperimentalConfig

    for kw in ({"profile_all_threads": True, "trace_only": True}, {"profile_all_threads": True},
               {}):
        try:
            return _ExperimentalConfig(**kw)
        except TypeError:
            continue
    return None


def _device_events(prof) -> list:
    """(name, start s, end s) of every device operation, on the profiler's clock."""
    cuda = torch.autograd.DeviceType.CUDA
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        out = []
        for e in results.events():
            if e.device_type() != cuda:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                s, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            out.append((e.name(), s, s + d))
        return out
    return [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6) for e in prof.events()
            if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]


class Tracer:
    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.device = torch.device(device)
        self.side = torch.cuda.Stream(self.device)
        cfg = _experimental()
        kw = {} if cfg is None else {"experimental_config": cfg}
        self.prof = profile(activities=[ProfilerActivity.CUDA], **kw)
        self.marks: list = []

    def _mark(self) -> None:
        with torch.cuda.stream(self.side):
            self.marks.append(time.perf_counter())
            torch.cuda._sleep(100)

    def start(self) -> None:
        self.prof.start()
        self._mark()

    def stop(self, lo: float, hi: float) -> dict:
        """The trace of [lo, hi] on the host clock: every device operation
        clipped to it."""
        self._mark()
        torch.cuda.synchronize(self.device)
        t_read = time.perf_counter()
        self.prof.stop()
        events = sorted(_device_events(self.prof), key=lambda e: e[1])
        starts = [s for n, s, _ in events if _MARK in n]
        if not starts:
            raise RuntimeError("trace: no marker kernel recorded")
        # a marker starts at or after its host time: the least difference is
        # the closest bound on the offset between the clocks.  The profiler's
        # buffers can fill on a long busy window and drop what follows, the
        # closing marker with it: the trace then ends at its last operation.
        offset = min(s - m for s, m in zip(starts, self.marks))
        if len(starts) < len(self.marks):
            hi = min(hi, max(e for _, _, e in events) - offset)
        ops = [(n, max(s - offset, lo), min(e - offset, hi)) for n, s, e in events
               if _MARK not in n and e - offset > lo and s - offset < hi]
        print(f"trace: {len(events)} device events, {len(ops)} in the window "
              f"{hi - lo:.3f} s, read in {time.perf_counter() - t_read:.1f} s",
              file=sys.stderr, flush=True)
        return {"lo": lo, "hi": hi, "ops": ops}
