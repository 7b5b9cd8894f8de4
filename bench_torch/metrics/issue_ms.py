"""issue_ms: the worker's host time per frame in ``Dock.push_nv12`` and
``Dock.render_async`` (the drag's mouse calls before the push included),
timed by the benchmark's wrapper around the two calls; the mean over the
window's frames."""


def read(run):
    t = [f.t_issue1 - f.t_issue0 for f in run.frames
         if f.t_issue0 is not None and f.t_issue1 is not None]
    return sum(t) / len(t) * 1e3 if t else None
