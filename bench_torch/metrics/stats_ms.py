"""stats_ms: K2's device time per frame, in ms: the union of the intervals
of its kernels (the vectorscope grid, the waveform grid, and the partials'
sum where it runs alone) over the panels that landed in the traced window.
The waveform grid starts as the vectorscope grid's programmatic dependent
and overlaps it, so the two are joined, not summed.  Read from the raw
names of the profiler's trace; None where no K2 kernel ran in it."""

from ..arith import busy

KERNELS = ("vs_count_kernel", "wv_count_kernel", "vs_reduce_kernel")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    n = sum(1 for f in run.frames if f.t_landed is not None and tr["lo"] <= f.t_landed < tr["hi"])
    spans = [(s, e) for name, s, e in tr["ops"] if any(k in name for k in KERNELS)]
    return busy(spans) / n * 1e3 if n and spans else None
