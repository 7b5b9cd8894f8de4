"""recaptures: the graphs captured in the window, a count: the program's
``step.captures`` counter (``graphs.CapturedStep``).  Every graph the
window replays is captured in the warm-up, so a capture here is set-up
work repeated on the hot path."""

from ..spans import counted, frames


def read(run):
    return counted(run, "step.captures") if frames(run) else None
