"""latency_p95_ms: the 95th percentile, over every frame due in the window
on every stream, of the time from when the frame was due to when its panel
was on the host.  A frame that never got there (dropped, failed) counts as
later than any other; if more than 5 % did, there is no 95th percentile
and the line leaves the metric out.  Read in the traced run, with the
profiler on, so it reads above what a user sees without it."""

import math

from ..arith import percentile


def read(run):
    lat = [(f.t_landed - f.due) * 1e3 if f.t_landed is not None else math.inf
           for f in run.frames]
    if not lat:
        return None
    p = percentile(lat, 95)
    return None if math.isinf(p) else p
