"""dock_self_ms: the worker's host time per frame in the Dock outside the
captured step, in ms: the program's ``dock.push_nv12``,
``dock.render_async`` and ``dock.mouse`` spans less the ``step.call``
spans inside them (route choice and keys, publication, the selection
outline, the drag's mouse routing).  With ``step_call_ms`` it makes up
what ``issue_ms`` times from outside."""

from ..spans import frames, self_ms

TOPS = ("dock.push_nv12", "dock.render_async", "dock.mouse")


def read(run):
    n = frames(run)
    own, _ = self_ms(run, TOPS, ("step.call",))
    return own / n if n else None
