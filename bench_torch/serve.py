"""The system under test, wired as a deployment runs it, and driven.

Each stream is one ``models.Dock`` behind its own
``pipeline.PipelineDriver(dock=, on_panel=sink)``; one producer thread, a
capture thread, hands each driver its frames' host NV12 planes in pageable
memory (``push_nv12``, the driver's pinned ring uploads them), the
driver's worker runs ``Dock.push_nv12`` and ``Dock.render_async`` (the
captured settled or dynamic dock step) and the sink copies the panel to the
host.  A frame counts when its panel is on the host.

A configuration file's ``"content"`` picks the picture (``POOLS``): the
camera scene of ``content`` (the default) or the desktop of ``screen``.

The benchmark's own wrappers around ``Dock.push_nv12`` and
``Dock.render_async`` time the worker's host work per frame, number the
frames as the dock consumes them and make the ROI drag's mouse calls before
each push.  Everything the program is given comes from the seed: the
frames (``content``), the schedule and the drag (``traffic.generator``).
"""

from __future__ import annotations

import collections
import gc
import sys
import threading
import time

import torch

from . import content, screen
from .traffic import generator

# a configuration file's "content": the pool maker of its frames
POOLS = {"camera": content.frame_pool, "screen": screen.frame_pool}
CONFIG_KEYS = {"source", "deployment", "frame", "content", "streams", "queue_depth", "dock",
               "roi", "assumed", "reduced"}


def config_problems(cfg: dict) -> list:
    """What in a configuration file the harness would not run as written:
    an unknown top-level key, an unknown picture, an interleave other than
    the 0 or 1 the hub takes (``ROIConfig`` clamps any other), and a wire
    format or range other than the NV12 limited range that ``encode_nv12``
    makes and ``push_nv12`` sends."""
    out = [f"unknown key {k!r}" for k in sorted(set(cfg) - CONFIG_KEYS)]
    if cfg.get("content", "camera") not in POOLS:
        out.append(f"content {cfg['content']!r} is not one of {sorted(POOLS)}")
    interleave = cfg.get("roi", {}).get("interleave")
    if interleave not in (0, 1):
        out.append(f"roi.interleave {interleave!r}: the hub takes 0 or 1")
    f = cfg.get("frame", {})
    if f.get("format") != "nv12":
        out.append(f"frame.format {f.get('format')!r}: only nv12 is fed")
    if f.get("range") != "limited":
        out.append(f"frame.range {f.get('range')!r}: only limited is fed")
    return out


class Record:
    """One frame of one stream, from its due time to its panel on the host."""

    __slots__ = ("stream", "index", "window", "pool", "due", "t_push", "t_pushed", "dropped",
                 "consumed", "t_issue0", "t_issue1", "t_landed", "sampled", "panel", "stats",
                 "dynamic")

    def __init__(self, stream: int, index: int, window: bool, pool: int, panel=None):
        """``panel``: for a frame whose answers are checked, the host buffer
        its panel lands in."""
        self.stream, self.index, self.window, self.pool = stream, index, window, pool
        self.sampled = panel is not None
        self.panel = panel
        self.due = self.t_push = self.t_pushed = None
        self.t_issue0 = self.t_issue1 = self.t_landed = None
        self.consumed = self.dynamic = None
        self.dropped = False
        self.stats = None


def _enum(cls, name: str):
    return cls[name.upper()]


def build_dock(cfg: dict, rect, device):
    """A ``models.Dock`` with the configuration's settings, the ROI at
    ``rect`` (x0, y0, x1, y1) or the whole capture (None)."""
    from obs_color_monitor_tpu_torch import config as c
    from obs_color_monitor_tpu_torch.models import Dock

    d = cfg["dock"]
    cs = _enum(c.Colorspace, d["colorspace"])
    vs, wv, hi, zb, fc, fp = (d[k] for k in ("vectorscope", "waveform", "histogram", "zebra",
                                             "falsecolor", "focuspeaking"))
    x0, y0, x1, y1 = rect if rect is not None else (-1, -1, -1, -1)
    return Dock(
        c.DockConfig(width=d["width"], height=d["height"],
                     **{f"show_{k}": v for k, v in d["show"].items()}),
        roi=c.ROIConfig(target_scale=d["target_scale"], colorspace=cs,
                        interleave=cfg["roi"]["interleave"], x0=x0, y0=y0, x1=x1, y1=y1),
        vectorscope=c.VectorscopeConfig(
            colorspace=cs, intensity=vs["intensity"],
            color_type=_enum(c.VectorscopeColorType, vs["color_type"]),
            graticule=c.GraticuleColor(vs["graticule"]),
            graticule_skintone_color=vs["skintone_bgr"], zoom=vs["zoom"]),
        waveform=c.WaveformConfig(
            colorspace=cs, display=_enum(c.DisplayMode, wv["display"]),
            components=_enum(c.Components, wv["components"]), intensity=wv["intensity"],
            graticule_lines=wv["graticule_lines"]),
        histogram=c.HistogramConfig(
            colorspace=cs, display=_enum(c.DisplayMode, hi["display"]),
            components=_enum(c.Components, hi["components"]), level_height=hi["level_height"],
            logscale=hi["logscale"], level_mode=_enum(c.LevelMode, hi["level_mode"]),
            graticule_vertical_lines=hi["graticule_vertical_lines"]),
        zebra=c.ZebraConfig(colorspace=cs, zebra_th_low=zb["th_low_percent"],
                            zebra_th_high=zb["th_high_percent"]),
        falsecolor=c.FalseColorConfig(colorspace=cs, show_key=_enum(c.ShowKey, fc["show_key"])),
        focuspeaking=c.FocusPeakingConfig(colorspace=cs, peaking_color=fp["peaking_color_abgr"],
                                          peaking_threshold=fp["peaking_threshold"],
                                          actual_size=fp["actual_size"]),
        device=device,
    )


class Stream:
    """One source: its frame pool, dock, driver, wrappers and records."""

    def __init__(self, k: int, cfg: dict, pool: list, drag, device):
        from obs_color_monitor_tpu_torch.pipeline import PipelineDriver

        self.k, self.pool, self.drag = k, pool, drag
        self.h = cfg["frame"]["height"]
        self.depth = cfg["queue_depth"]
        self.dock = build_dock(cfg, drag.initial() if drag else None, device)
        self.driver = PipelineDriver(dock=self.dock, on_panel=self.sink,
                                     queue_depth=self.depth)
        self.fifo: collections.deque = collections.deque()  # accepted, not yet consumed
        self.consumed: list[Record] = []  # in the dock's order
        self.records: list[Record] = []
        self.current: Record | None = None
        self.host = None  # the sink's pinned panel buffer
        self.carry = None  # a refused checked frame's panel buffer, for the next frame taken
        self.refused_checked = 0
        self._wrap()

    def _wrap(self) -> None:
        dock = self.dock
        push, render = dock.push_nv12, dock.render_async

        def push_nv12(y, uv, cs=None, shift=0):
            rec = self.fifo.popleft()
            rec.consumed = len(self.consumed)
            self.consumed.append(rec)
            self.current = rec
            rec.t_issue0 = time.perf_counter()
            if self.drag is not None:
                for method, x, yy in self.drag.events(rec.consumed):
                    getattr(dock, method)(x, yy)
            push(y, uv, cs=cs, shift=shift)

        def render_async(width=None, height=None):
            panel = render(width, height)
            self.current.t_issue1 = time.perf_counter()
            return panel

        dock.push_nv12, dock.render_async = push_nv12, render_async

    def sink(self, panel) -> None:
        """The panel to the host: into one pinned buffer reused frame after
        frame, as a display or encoder's reader keeps one, or, for a frame
        whose answers are checked, into the pinned buffer set aside for it
        before the window, so that a checked frame costs the worker no more
        than any other.  Also whether the dock published the frame as a
        dynamic-rect surface (the dragged route), and a checked frame's
        statistics, kept for the comparison."""
        rec = self.current
        if rec.panel is None:
            if self.host is None or self.host.shape != panel.shape:
                self.host = torch.empty(panel.shape, dtype=panel.dtype,
                                        pin_memory=panel.device.type == "cuda")
            dst = self.host
        else:
            dst = rec.panel
        dst.copy_(panel)
        rec.t_landed = time.perf_counter()
        surface = self.dock.hub.last_surface
        rec.dynamic = surface.dynamic_rect is not None
        if rec.sampled:
            r = surface.result
            rec.stats = (r.planes, r.vs_counts, r.wv_rgb, r.hi_rgb)

    def push(self, rec: Record) -> None:
        """Offer ``rec``'s frame to the driver.  A frame the driver refuses
        on a full queue is dropped, as the reference's graphics thread drops
        it (src/common.c:260-268): it is never consumed and no panel is owed
        for it.  A checked frame that is refused is no longer checked; its
        panel buffer passes to the next window frame offered that is not
        checked already, and on again if that one is refused too, so that
        a host stall costs the check no frame."""
        if self.carry is not None and rec.window and rec.panel is None:
            rec.panel, rec.sampled, self.carry = self.carry, True, None
        buf = self.pool[rec.pool]
        rec.t_push = time.perf_counter()
        self.fifo.append(rec)
        if not self.driver.push_nv12(buf[:self.h], buf[self.h:]):
            self.fifo.pop()
            rec.dropped = True
            if rec.sampled:
                self.carry, rec.panel, rec.sampled = rec.panel, None, False
                self.refused_checked += 1
        rec.t_pushed = time.perf_counter()
        self.records.append(rec)


SPIN_S = 0.002  # the last stretch before a frame is due, waited out awake


def _sleep_until(t: float) -> None:
    """Until ``t`` on the host's clock: asleep until SPIN_S before it, then
    awake, reading the clock and yielding the interpreter in turn.  A
    sleeping thread wakes a median 0.55 ms late on the card's host, and
    that lateness would count in every frame's latency."""
    d = t - time.perf_counter() - SPIN_S
    if d > 0:
        time.sleep(d)
    while time.perf_counter() < t:
        time.sleep(0)


class Cell:
    """A cell's streams, built and warmed in set-up, then driven for a window."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, docks: bool = True):
        bad = config_problems(cfg)
        if bad:
            raise ValueError("configuration: " + "; ".join(bad))
        self.cfg, self.t, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        f = cfg["frame"]
        self.h, self.w = f["height"], f["width"]
        n_streams = cfg["streams"]
        n_pool = generator.pool_frames(traffic, n_streams, self.h * self.w * 3 // 2)
        make = POOLS[cfg.get("content", "camera")]
        self.pools = [make(seed, s, n_pool, self.h, self.w, f["colorspace"], self.device)
                      for s in range(n_streams)]
        self.drag = None
        if traffic["roi"]["path"] == "drag":
            from .reference.panel import DockReference

            ref = DockReference(cfg["dock"], self.h, self.w, "cpu")
            self.drag = generator.DragPath(traffic["roi"], ref.sw, ref.sh, ref.out_w, ref.out_h,
                                           len(ref.shown), ref.dynamic_layout()["roi"])
        self.streams = [Stream(s, cfg, self.pools[s], self.drag, self.device)
                        for s in range(n_streams)] if docks else []

    @staticmethod
    def _counter() -> int:
        """K2's launches with a rect tensor: on a card, only the dynamic dock
        step (the dragged route) makes them."""
        from obs_color_monitor_tpu_torch.ops import scope_stats

        return scope_stats.vs_wv_counts.launches_rect

    def start(self) -> None:
        for s in self.streams:
            s.driver.start()

    def stop(self) -> None:
        for s in self.streams:
            s.driver.stop()

    def flush(self, timeout: float = 60.0) -> None:
        for s in self.streams:
            s.driver.flush(timeout=timeout)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Each stream, one after another, through ``warmup_frames`` frames,
        each landed before the next is pushed: the pinned ring, the graph
        captures and the route of the window all set up before it opens."""
        for s in self.streams:
            for i in range(self.t["warmup_frames"]):
                rec = Record(s.k, i, False, i % len(s.pool))
                rec.due = time.perf_counter()
                s.push(rec)
                s.driver.flush(timeout=120.0)
        self.flush()

    def _produce_open(self, t0: float, n: int, checked: list) -> None:
        """Every stream's frames in the order they fall due, as one capture
        thread hands each source's frame over in turn (OBS's graphics thread
        renders every source of a tick one after another).  ``checked[k]``
        maps a window frame of stream k whose answers are checked to the
        host buffer its panel lands in."""
        due = sorted((generator.due_offset(self.t, i), s.k, i)
                     for s in self.streams for i in range(n))
        for offset, k, i in due:
            s = self.streams[k]
            rec = Record(k, i, True, i % len(s.pool), checked[k].get(i))
            rec.due = t0 + offset
            _sleep_until(rec.due)
            s.push(rec)

    def _checked_buffers(self, n_plan: int) -> list:
        """For each stream, {window frame: pinned host buffer} over the
        frames whose answers are checked, drawn from the seed."""
        out = []
        for s in self.streams:
            idx = sorted(generator.sample(self.t, self.seed, s.k, len(self.streams), n_plan))
            bufs = torch.empty((len(idx), *s.host.shape), dtype=s.host.dtype,
                               pin_memory=self.device.type == "cuda")
            out.append(dict(zip(idx, bufs)))
        return out

    def window(self, seconds: float, tracer=None) -> dict:
        """Drive every stream for ``seconds`` and wait until every frame
        pushed has landed or failed.  Returns the window's timing and each
        dock's frames skipped in it (``hub.frames_skipped``).  The garbage
        collector's pauses in the window are timed."""
        pauses: list = []
        started: list = []

        def on_gc(phase, info):
            if phase == "start":
                started.append(time.perf_counter())
            elif started:
                pauses.append((info["generation"], time.perf_counter() - started.pop()))

        n_plan = generator.plan(self.t, seconds)
        checked = self._checked_buffers(n_plan)
        gc.callbacks.append(on_gc)
        stage0 = [dict(s.driver.staging) for s in self.streams]
        skip0 = [s.dock.hub.frames_skipped for s in self.streams]
        route0 = self._counter()
        t_ready = time.perf_counter()  # set-up ends; the profiler's start is the benchmark's
        if tracer is not None:
            tracer.start()
        t0 = time.perf_counter() + 0.05
        t_end = t0 + seconds
        producer = threading.Thread(target=self._produce_open,
                                    args=(t0, n_plan, checked), name="producer",
                                    daemon=True)
        producer.start()
        producer.join()
        self.flush()
        t_close = time.perf_counter()
        gc.callbacks.remove(on_gc)
        if pauses:
            print(f"gc: {len(pauses)} collections in the window, generation 2: "
                  f"{sum(g == 2 for g, _ in pauses)}, longest {max(d for _, d in pauses) * 1e3:.1f} ms",
                  file=sys.stderr, flush=True)
        trace = tracer.stop(t0, t_end) if tracer is not None else None
        staging = {k: sum(s.driver.staging[k] - s0[k] for s, s0 in zip(self.streams, stage0))
                   for k in ("uploads", "host_copy_s", "wait_s")}
        return {"t_ready": t_ready, "t0": t0, "t_end": t_end, "t_close": t_close, "n_plan": n_plan,
                "staging": staging, "route_launches": self._counter() - route0,
                "skipped": [s.dock.hub.frames_skipped - k for s, k in zip(self.streams, skip0)],
                "errors": sum(s.driver.stats["errors"] for s in self.streams), "trace": trace}

    def window_records(self) -> list:
        return [r for s in self.streams for r in s.records if r.window]
