"""Whether what the timed path produced is correct.

The frames checked are a sample, drawn from the seed, of the frames due in
the window (``traffic.generator.sample``).  For each, the panel the sink
copied to the host and the statistics the dock published with it (the
capture's planes, the vectorscope, waveform and histogram counts) are
compared exactly with the plain reference (``reference/``), computed from
the NV12 frames the dock was given, the zebra clock of the dock's tick
count and, on a dragged ROI, the rect that the drag's mouse calls commit.
Every limit is 0: the scopes are exact.

Which frame a row shows follows the reference plugin, not the program:

- The interleave ``n`` (the configuration's ``roi.interleave``): the ROI
  source keeps a counter, 0 at its start, that advances once per rendered
  frame and wraps to 0 past ``n``; a frame whose tick finds it at 0 is
  analysed, any other is skipped (src/roi.c:266-277,523-532).  The dock
  renders every frame it consumes, so its j-th frame, counted from the
  first warm-up frame on, is analysed when ``j % (n + 1) == 0``.  A dropped
  frame is never consumed and advances nothing.
- An analysed frame j: every row and every published statistic is frame
  j's, except the waveform row, which shows its read buffer, advanced only
  at a tick to the last statistics published (src/waveform.c:394-400):
  those of the analysed frame before, ``j - n - 1`` (the frame before at
  ``n = 0``).
- A skipped frame j: nothing is analysed or published, and the panel is
  drawn again from what was: every row and statistic, the waveform row
  too, is that of the last analysed frame ``j - j % (n + 1)``; only the
  zebra row moves, drawn at frame j's clock, which advances at every tick
  (src/zebra.c:660-673).
- A dragged ROI is checked at ``n = 0`` only: every row shows the rect
  that frame j's mouse calls commit.

A checked frame is one the driver took: a frame it refuses on a full
queue is dropped, as the reference's graphics thread drops it
(src/common.c:260-268), is never consumed, advances no counter and is owed
no panel; it counts as failed and as later than any in the latency, and
the next frame offered is checked in its place (``serve.Stream.push``).  A
checked frame that the driver took and whose panel never reached the host
is missing.

A window frame on the wrong route is a route error, counted on a card
twice, by the dock's publication (a dynamic-rect surface) and by the
launch counter that only the dynamic step moves, and on every device by
the frames the dock skipped in the window against the number the
interleave rule gives for the window frames it consumed.
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


def analysed(j: int, interleave: int) -> bool:
    """Whether the dock's j-th frame is analysed, by the rules above."""
    return j % (interleave + 1) == 0


def sources(j: int, interleave: int) -> tuple:
    """(the frame whose capture and statistics the dock's j-th frame
    shows, the frame its waveform row shows), by the rules above."""
    if not analysed(j, interleave):
        last = j - j % (interleave + 1)
        return last, last
    return j, j - interleave - 1 if j > interleave else j


class Expect:
    """The reference's panel and statistics of a stream's frames."""

    def __init__(self, cell, device, ds_dtype=torch.float32):
        self.cell = cell
        self.interleave = cell.cfg["roi"]["interleave"]
        if cell.drag is not None and self.interleave:
            raise ValueError("the check models a dragged ROI at roi.interleave 0 only")
        self.ref = DockReference(cell.cfg["dock"], cell.h, cell.w, device, ds_dtype)
        self.dev = torch.device(device)
        self._frames: dict = {}

    def frame(self, stream: int, pool: int) -> Frame:
        key = (stream, pool)
        if key not in self._frames:
            buf = torch.from_numpy(self.cell.pools[stream][pool])
            self._frames[key] = self.ref.frame(buf[:self.cell.h], buf[self.cell.h:])
        return self._frames[key]

    def of(self, stream: int, pools, j: int, tm: float):
        """(panel, (capture, vs, wv, hi)) of the dock's j-th frame, where
        ``pools[k]`` is the pool index of the k-th frame it consumed."""
        drag = self.cell.drag
        if drag is not None and j >= drag.press_at:
            rect = drag.rect(j)
            cap = self.frame(stream, pools[j]).capture
            return self.ref.dynamic_panel(cap, rect, tm), self.ref.rect_stats(cap, rect)
        shown, wave = sources(j, self.interleave)
        cur = self.frame(stream, pools[shown])
        return self.ref.settled_panel(cur, self.frame(stream, pools[wave]), tm), cur


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
    """The numbers compared, each with its limit, in the order printed, how
    many checked frames were analysed and skipped, and how many times the
    driver refused a checked frame (and how many of those found no frame to
    take their place before the window closed)."""
    nums = dict.fromkeys(LIMITS, 0)
    expect = Expect(cell, device)
    tms = clock(max(len(s.consumed) for s in cell.streams))
    checked = sampled = 0
    kinds = {True: 0, False: 0}
    for s in cell.streams:
        pools = [r.pool for r in s.consumed]
        for rec in s.records:
            if not (rec.window and rec.sampled):
                continue
            sampled += 1
            if rec.t_landed is None:
                nums["missing"] += 1
                continue
            j = rec.consumed
            want = expect.of(s.k, pools, j, tms[j])
            panel = rec.panel.numpy()
            off = compare(want, panel, rec.stats, expect.dev)
            for k, v in off.items():
                nums[k] += v
            if off["panel_bytes_off"] and want[0].shape == panel.shape:
                where(s.k, j, want[0], panel)
            checked += 1
            kinds[analysed(j, expect.interleave)] += 1
    landed = [r for s in cell.streams for r in s.records if r.window and r.t_landed is not None]
    expected = len(landed) if cell.drag is not None else 0
    nums["route_off"] = abs(sum(1 for r in landed if r.dynamic) - expected)
    if cell.device.type == "cuda":  # the kernels count their launches on a card
        nums["route_off"] += abs(window["route_launches"] - expected)
    for s, skipped in zip(cell.streams, window["skipped"]):
        rule = sum(1 for r in s.consumed if r.window and not analysed(r.consumed, expect.interleave))
        nums["route_off"] += abs(skipped - rule)
    return {"checked": checked, "sampled": sampled, "analysed": kinds[True],
            "skipped": kinds[False],
            "refused": sum(s.refused_checked for s in cell.streams),
            "unplaced": sum(s.carry is not None for s in cell.streams),
            "numbers": {k: (v, LIMITS[k]) for k, v in nums.items()}}
