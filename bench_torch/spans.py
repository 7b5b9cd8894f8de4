"""The program's own spans, device times and counters in a traced run:
``window["program"]``, the port's ``pipeline.profiler.snapshot()`` over the
window (absent from untraced runs, and from a program without the
recorder).  A record counts when it ends in the window ``[t0, t_end]``;
per frame means over the ``pipeline_loop`` spans (one a frame the worker
consumed) that end there.  Every function gives an empty list, 0 frames,
where there is nothing to read."""

from __future__ import annotations


def _program(run):
    return run.window.get("program")


def _inside(run, t) -> bool:
    return t is not None and run.window["t0"] <= t <= run.window["t_end"]


def spans(run, *names) -> list:
    """The finished spans of ``names`` that end in the window."""
    p = _program(run)
    return [] if not p else [s for s in p["spans"] if s["name"] in names and _inside(run, s["t1"])]


def device(run, name: str) -> list:
    """The device times (ms) of the ``name`` event pairs whose closing
    event was recorded in the window; an unresolved pair is left out."""
    p = _program(run)
    return [] if not p else [d["ms"] for d in p["device"] if d["name"] == name
                             and d["ms"] is not None and _inside(run, d["t1"])]


def pairs(run, name: str) -> int:
    """The ``name`` event pairs closed in the window, resolved or not."""
    p = _program(run)
    return 0 if not p else sum(1 for d in p["device"] if d["name"] == name and _inside(run, d["t1"]))


def counted(run, name: str) -> float:
    """The counter ``name``'s increments made in the window."""
    p = _program(run)
    return 0 if not p else sum(c["n"] for c in p["counts"] if c["name"] == name
                               and _inside(run, c["t"]))


def frames(run) -> int:
    return len(spans(run, "pipeline_loop"))


def ms(s: dict) -> float:
    return (s["t1"] - s["t0"]) * 1e3


def self_ms(run, tops: tuple, children: tuple) -> tuple:
    """(the ``tops`` spans' self time, their ``children`` descendants'
    time), in ms, over the top spans that end in the window and lie inside
    no other top span.  A child's time counts once, under its nearest top
    span."""
    p = _program(run)
    if not p:
        return 0.0, 0.0
    by_id = {s["id"]: s for s in p["spans"]}

    def top_of(s):
        """The outermost span of ``tops`` above ``s`` (``s`` itself
        included), or None."""
        found = None
        while s is not None:
            if s["name"] in tops:
                found = s
            s = by_id.get(s["parent"])
        return found

    outer = [s for s in spans(run, *tops) if top_of(s) is s]
    ids = {s["id"] for s in outer}
    inner = 0.0
    for c in p["spans"]:
        if c["name"] in children and c["t1"] is not None:
            top = top_of(by_id.get(c["parent"]))
            if top is not None and top["id"] in ids:
                inner += ms(c)
    return sum(ms(s) for s in outer) - inner, inner
