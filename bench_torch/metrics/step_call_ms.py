"""step_call_ms: the worker's host time in the captured dock step per
frame, in ms: the program's ``step.call`` spans (``graphs.CapturedStep``:
the input fills, the graph replay's issue, the output clones, a capture
when one is made) over the frames the worker consumed."""

from ..spans import frames, ms, spans


def read(run):
    n = frames(run)
    calls = spans(run, "step.call")
    return sum(ms(s) for s in calls) / n if n and calls else None
