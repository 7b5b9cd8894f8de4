"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and gives the producers their schedule, the content
pool size, the frames whose answers are checked, and the ROI's path.

A mix's keys:

- ``fps``: frames per second per stream, each due on a clock whether or
  not the scope keeps up (an open loop), every stream's frame due at the
  same instant (genlocked);
- ``pool_bytes``: the NV12 bytes the distinct frames of all streams
  together at least span (past the card's 50 MB L2);
- ``warmup_frames``: frames per stream pushed in set-up;
- ``checked_frames``: frames per run, over all streams, whose panel and
  statistics the check compares;
- ``roi``: ``{"path": "settled"}`` (the whole capture), or
  ``{"path": "drag", "size_div": 4, "start": [fx, fy], "step": [dx, dy],
  "press_at": n}``: a rect of 1/size_div of the capture's width and
  height, at fractions (fx, fy) of the capture, grabbed at its centre
  through the dock's ``mouse_down`` at the n-th frame and moved ``step``
  scaled pixels a frame by ``mouse_move``, bouncing at the edges.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path

from ..reference.panel import fit

TRAFFIC_DIR = Path(__file__).resolve().parent
_KEYS = {"fps", "pool_bytes", "warmup_frames", "checked_frames", "roi"}


def load(mix: str) -> dict:
    path = TRAFFIC_DIR / f"{mix}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {mix!r} ({path.name} under traffic/)")
    t = json.loads(path.read_text())
    unknown = set(t) - _KEYS
    if unknown:
        raise ValueError(f"traffic {mix}: unknown keys {sorted(unknown)}")
    if t["roi"]["path"] not in ("settled", "drag"):
        raise ValueError(f"traffic {mix}: roi path must be settled or drag")
    return t


def pool_frames(t: dict, streams: int, frame_bytes: int) -> int:
    """Distinct frames per stream: enough that all streams' pools together
    span ``pool_bytes``, and at least 2."""
    return max(2, math.ceil(t["pool_bytes"] / (streams * frame_bytes)))


def plan(t: dict, seconds: float) -> int:
    """Frames per stream the window is planned to take."""
    return int(round(seconds * t["fps"]))


def due_offset(t: dict, i: int) -> float:
    """Seconds from the window's start at which the i-th frame of every
    stream is due."""
    return i / t["fps"]


def sample(t: dict, seed: int, stream: int, streams: int, n_plan: int) -> set:
    """The indices, among a stream's planned window frames, whose answers
    are checked: drawn from the seed."""
    k = min(n_plan, math.ceil(t["checked_frames"] / streams))
    return set(random.Random(seed * 7919 + stream).sample(range(n_plan), k))


def _bounce(x: float, lo: float, hi: float) -> float:
    period = 2 * (hi - lo)
    u = (x - lo) % period
    return lo + (u if u <= hi - lo else period - u)


class DragPath:
    """The ROI drag of a ``roi.path == "drag"`` mix on a dock whose panel is
    ``out_w`` x ``out_h`` with ``n_rows`` rows shown, the preview first, on
    a (sw, sh) capture.  ``events(j)`` are the dock's mouse calls before
    its j-th frame; ``rect(j)`` is the rect those calls commit, worked out
    from the same pointer positions as the dock's own mapping does it:
    panel to capture coordinates by the preview row's band, a move-drag
    shifting the rect by the pointer's step."""

    MARGIN = 8  # capture pixels kept between the rect and the edges

    def __init__(self, roi: dict, sw: int, sh: int, out_w: int, out_h: int, n_rows: int,
                 dyn_band: tuple):
        self.rw, self.rh = sw // roi["size_div"], sh // roi["size_div"]
        self.o0 = (int(roi["start"][0] * (sw - self.rw)), int(roi["start"][1] * (sh - self.rh)))
        self.step = roi["step"]
        self.press_at = roi["press_at"]
        self.sw, self.sh = sw, sh
        # the settled preview shows the crop, fitted into the first row
        bw, bh = fit(out_w, out_h // n_rows, self.rw, self.rh)
        bx = (out_w - bw) // 2
        self.p0 = (bx + bw // 2, bh // 2)
        self.grab = ((self.p0[0] - bx) * self.rw // bw + self.o0[0],
                     self.p0[1] * self.rh // bh + self.o0[1])
        # while dragged, the preview shows the whole capture
        self.band = dyn_band

    def initial(self) -> tuple:
        return (*self.o0, self.o0[0] + self.rw, self.o0[1] + self.rh)

    def _pointer(self, j: int) -> tuple:
        """Panel point of the pointer at frame j > press_at: its capture
        target bounces so the rect stays MARGIN inside the capture."""
        bx, by, bw, bh = self.band
        out = []
        for a, (size, full, o0, g) in enumerate(((self.rw, self.sw, self.o0[0], self.grab[0]),
                                                 (self.rh, self.sh, self.o0[1], self.grab[1]))):
            lo = g - (o0 - self.MARGIN)
            hi = g + (full - size - o0 - self.MARGIN)
            target = _bounce(g + self.step[a] * (j - self.press_at), lo, hi)
            b0, bs = (bx, bw) if a == 0 else (by, bh)
            out.append(b0 + math.ceil(target * bs / full))
        return tuple(out)

    def _capture(self, p: tuple) -> tuple:
        bx, by, bw, bh = self.band
        return (p[0] - bx) * self.sw // bw, (p[1] - by) * self.sh // bh

    def events(self, j: int) -> list:
        """[(method, x, y)] to call on the dock before its j-th frame."""
        if j == self.press_at:
            return [("mouse_move", *self.p0), ("mouse_down", *self.p0)]
        if j > self.press_at:
            return [("mouse_move", *self._pointer(j))]
        return []

    def rect(self, j: int) -> tuple:
        """The committed (x0, y0, x1, y1) of the dock's j-th frame."""
        if j <= self.press_at:
            return self.initial()
        cx, cy = self._capture(self._pointer(j))
        x0, y0 = self.o0[0] + cx - self.grab[0], self.o0[1] + cy - self.grab[1]
        return x0, y0, x0 + self.rw, y0 + self.rh
