"""Whether what the timed path produced is correct.

The frames checked are a sample, drawn from the seed, of the frames due in
the window (``traffic.generator.sample``).  For each, the panel the sink
copied to the host and the statistics the dock published with it (the
capture's planes, the vectorscope, waveform and histogram counts) are
compared exactly with the plain reference (``reference/``), computed from
the same NV12 frame, the zebra clock of the dock's tick count, the frame
before (the settled waveform row) and, on a dragged ROI, the rect that
the drag's mouse calls commit.  Every limit is 0: the scopes are exact.

A checked frame that never reached the host is missing; a window frame on
the wrong route is a route error, counted twice on a card: by the dock's
publication (a dynamic-rect surface) and by the launch counter that only
the dynamic step moves.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .reference import golden
from .reference.panel import DockReference, Frame

LIMITS = {"panel_bytes_off": 0, "capture_bytes_off": 0, "counts_off": 0, "missing": 0,
          "route_off": 0}


def clock(n: int) -> list:
    """The zebra clock after each of the dock's first ``n`` frames."""
    out, tm = [], 0.0
    for _ in range(n):
        tm = golden.zebra_tm_advance(tm, 1.0 / 60.0)
        out.append(tm)
    return out


class Expect:
    """The reference's panel and statistics of a stream's frames."""

    def __init__(self, cell, device, ds_dtype=torch.float32):
        self.cell = cell
        self.ref = DockReference(cell.cfg["dock"], cell.h, cell.w, device, ds_dtype)
        self.dev = torch.device(device)
        self._frames: dict = {}

    def frame(self, stream: int, pool: int) -> Frame:
        key = (stream, pool)
        if key not in self._frames:
            buf = torch.from_numpy(self.cell.pools[stream][pool])
            self._frames[key] = self.ref.frame(buf[:self.cell.h], buf[self.cell.h:])
        return self._frames[key]

    def of(self, stream: int, pool: int, prev_pool: int, j: int, tm: float):
        """(panel, (capture, vs, wv, hi)) of the dock's j-th frame."""
        cur = self.frame(stream, pool)
        drag = self.cell.drag
        if drag is not None and j >= drag.press_at:
            rect = drag.rect(j)
            f = self.ref.rect_stats(cur.capture, rect)
            return self.ref.dynamic_panel(cur.capture, rect, tm), f
        return self.ref.settled_panel(cur, self.frame(stream, prev_pool), tm), cur


def compare(want, got_panel: np.ndarray, got_stats, dev) -> dict:
    """Bytes of the panel and capture that differ, and the summed absolute
    difference of the counts."""
    panel, f = want
    planes, vs, wv, hi = (t.to(dev) for t in got_stats)

    def bytes_off(got, ref):  # every byte is off where the shapes differ
        return int((got != ref).sum()) if got.shape == ref.shape else ref.numel()

    def abs_off(got, ref):  # a count of a missing bin or column is off by itself
        if got.shape != ref.shape:
            return int(ref.abs().sum()) + 1
        return int((got.to(torch.int64) - ref).abs().sum())

    return {
        "panel_bytes_off": bytes_off(torch.from_numpy(got_panel).to(dev), panel),
        "capture_bytes_off": bytes_off(planes.permute(1, 2, 0), f.capture),
        "counts_off": abs_off(vs, f.vs) + abs_off(wv, f.wv) + abs_off(hi, f.hi),
    }


def where(stream: int, j: int, want: torch.Tensor, got) -> None:
    """Where a panel differs: its bounding box and a few pixels, on stderr."""
    got = torch.from_numpy(got).to(want.device)
    ys, xs = torch.nonzero((got != want).any(-1), as_tuple=True)
    pix = [(int(y), int(x), got[y, x].tolist(), want[y, x].tolist())
           for y, x in list(zip(ys, xs))[:4]]
    print(f"stream {stream} frame {j}: {len(ys)} panel pixels differ, rows {int(ys.min())}-"
          f"{int(ys.max())}, columns {int(xs.min())}-{int(xs.max())}; (row, col, got, want) "
          f"{pix}", file=sys.stderr, flush=True)


def check(cell, window: dict, device) -> dict:
    """The numbers compared, each with its limit, in the order printed."""
    nums = dict.fromkeys(LIMITS, 0)
    expect = Expect(cell, device)
    tms = clock(max(len(s.consumed) for s in cell.streams))
    checked = sampled = 0
    for s in cell.streams:
        for rec in s.records:
            if not (rec.window and rec.sampled):
                continue
            sampled += 1
            if rec.t_landed is None:
                nums["missing"] += 1
                continue
            j = rec.consumed
            prev = s.consumed[j - 1].pool if j > 0 else rec.pool
            want = expect.of(s.k, rec.pool, prev, j, tms[j])
            panel = rec.panel.numpy()
            off = compare(want, panel, rec.stats, expect.dev)
            for k, v in off.items():
                nums[k] += v
            if off["panel_bytes_off"] and want[0].shape == panel.shape:
                where(s.k, j, want[0], panel)
            checked += 1
    landed = [r for s in cell.streams for r in s.records if r.window and r.t_landed is not None]
    expected = len(landed) if cell.drag is not None else 0
    nums["route_off"] = abs(sum(1 for r in landed if r.dynamic) - expected)
    if cell.device.type == "cuda":  # the kernels count their launches on a card
        nums["route_off"] += abs(window["route_launches"] - expected)
    return {"checked": checked, "sampled": sampled,
            "numbers": {k: (v, LIMITS[k]) for k, v in nums.items()}}
