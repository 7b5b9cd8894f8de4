"""The port's span recorder (``pipeline.profiler``) inside the driver, the
Dock and the captured step, and the benchmark's readers of its snapshot.

On the CPU: a driver-fed ``models.Dock`` fed by ``push_nv12`` records one
frame id from the producer's push to the sink, children inside their
parents, drops by cause, a bounded ring, and nothing at all while off; the
readers of ``bench_torch/metrics`` on a synthetic snapshot.  Marked
``cuda`` (skips without a card): the CUDA-event pairs resolve after a
flush, and ``step.captures`` counts captures, not replays.  No JAX here:

    python -m pytest tests/test_torch_profiler_spans.py -m cuda -q --noconftest
"""

from __future__ import annotations

import threading
import types

import numpy as np
import pytest
import torch

from bench_torch import spans as bench_spans
from bench_torch import spec
from obs_color_monitor_tpu_torch.config import DockConfig, ROIConfig
from obs_color_monitor_tpu_torch.graphs import captured
from obs_color_monitor_tpu_torch.models import Dock
from obs_color_monitor_tpu_torch.pipeline import PipelineDriver, profiler

H, W = 48, 96
ROUTE_SPANS = ("queue.wait", "pipeline_loop", "dock.render_async", "dock.settled", "step.call",
               "dock.publish", "driver.on_panel")


@pytest.fixture
def recorder():
    """The recorder reset and on; off and reset after."""
    profiler.reset()
    profiler.enable(True)
    try:
        yield profiler
    finally:
        profiler.enable(False)
        profiler.reset()


def _planes(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H * 3 // 2, W), dtype=np.uint8) for _ in range(n)]


def _driver(device="cpu", depth: int = 3):
    dock = Dock(DockConfig(), roi=ROIConfig(interleave=0, target_scale=2), device=device)
    panels = []
    return PipelineDriver(dock=dock, on_panel=panels.append, queue_depth=depth), panels


def _rgba(b) -> np.ndarray:
    """An opaque (H, W, 4) frame made of an NV12 buffer's bytes."""
    f = np.repeat(b[:H, :, None], 4, axis=2)
    f[..., 3] = 255
    return f


def _feed(drv, planes, rgba: bool = False) -> None:
    for b in planes:
        assert drv.push_frame(_rgba(b)) if rgba else drv.push_nv12(b[:H], b[H:])
        drv.flush()


def _traced_frames(n: int, device="cpu", rgba: bool = False) -> dict:
    """A snapshot of ``n`` driver-fed frames on the settled route, the
    warm-up before it untraced."""
    drv, _ = _driver(device)
    drv.start()
    try:
        _feed(drv, _planes(3), rgba)
        profiler.reset()
        profiler.enable(True)
        try:
            _feed(drv, _planes(n, seed=1), rgba)
            return profiler.snapshot()
        finally:
            profiler.enable(False)
    finally:
        drv.stop()


def _by_fid(snap: dict) -> dict:
    out: dict = {}
    for s in snap["spans"]:
        out.setdefault(s["fid"], []).append(s)
    return out


@pytest.mark.parametrize("path", ["nv12", "frame"])
def test_one_frame_id_from_push_to_sink(path):
    """Every frame's spans, from the producer's push (``push_nv12`` or
    ``push_frame``) through the queue, the worker, the Dock's settled route
    and the captured step to the sink, share one frame id, and each frame
    has one of each."""
    try:
        snap = _traced_frames(4, rgba=path == "frame")
    finally:
        profiler.reset()
    push = f"producer.push_{path}"
    frames = _by_fid(snap)
    assert len(frames) == 4
    for fid, spans in frames.items():
        names = sorted(s["name"] for s in spans)
        assert names == sorted((push, f"dock.push_{path}") + ROUTE_SPANS), (fid, names)
    threads = snap["threads"]
    for spans in frames.values():
        by = {s["name"]: s for s in spans}
        assert threads[by["pipeline_loop"]["thread"]] == "color-monitor"
        assert by[push]["thread"] != by["pipeline_loop"]["thread"]
        # the wait starts before the push returns, ends before the worker's frame
        assert by["queue.wait"]["t0"] <= by[push]["t1"]
        assert by["queue.wait"]["t1"] <= by["pipeline_loop"]["t0"]


def test_children_nest_inside_parents_and_self_time():
    """A span's parent is open on its thread around it, in its frame; the
    parents are the route's layers; a parent's self time is its duration
    less its children's."""
    try:
        snap = _traced_frames(3)
    finally:
        profiler.reset()
    by_id = {s["id"]: s for s in snap["spans"]}
    parent_of = {}
    for s in snap["spans"]:
        if s["parent"] is None:
            continue
        p = by_id[s["parent"]]
        assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"]
        assert p["thread"] == s["thread"] and p["fid"] == s["fid"]
        parent_of[s["name"]] = p["name"]
    assert parent_of == {"dock.push_nv12": "pipeline_loop", "dock.render_async": "pipeline_loop",
                         "driver.on_panel": "pipeline_loop", "dock.settled": "dock.render_async",
                         "step.call": "dock.settled", "dock.publish": "dock.settled"}
    roots = {s["name"] for s in snap["spans"] if s["parent"] is None}
    assert roots == {"producer.push_nv12", "queue.wait", "pipeline_loop"}
    run = types.SimpleNamespace(window={"t0": 0.0, "t_end": float("inf"), "program": snap})
    for top in ("pipeline_loop", "dock.settled"):
        kids = [s for s in snap["spans"] if s["parent"] is not None
                and by_id[s["parent"]]["name"] == top]
        own, inner = bench_spans.self_ms(run, (top,), tuple({k["name"] for k in kids}))
        whole = sum(bench_spans.ms(s) for s in snap["spans"] if s["name"] == top)
        assert inner == pytest.approx(sum(bench_spans.ms(k) for k in kids))
        assert own == pytest.approx(whole - inner) and own >= 0


def test_dynamic_route_mouse_and_indicator(recorder):
    """A drag of a sub-rect through a directly driven Dock: the mouse
    calls, the dynamic route, its publication and the selection outline,
    each in its span."""
    dock = Dock(DockConfig(), roi=ROIConfig(interleave=0, target_scale=2, x0=8, y0=4, x1=32,
                                            y1=16), device="cpu")
    planes = _planes(5)
    for b in planes[:2]:
        dock.push_nv12(b[:H], b[H:])
        dock.render_async()
    x0, y0, w, h, _, _ = dock._rects["roi"]
    x, y = x0 + w // 2, y0 + h // 2
    profiler.reset()
    dock.mouse_move(x, y)
    dock.mouse_down(x, y)
    for k, b in enumerate(planes[2:]):
        dock.mouse_move(x + 2 * (k + 1), y + k + 1)
        dock.push_nv12(b[:H], b[H:])
        dock.render_async()
    snap = recorder.snapshot()
    by_id = {s["id"]: s for s in snap["spans"]}
    names = [s["name"] for s in snap["spans"]]
    assert names.count("dock.mouse") == 5
    assert names.count("dock.dynamic") == 3 and names.count("dock.indicator") == 3
    for s in snap["spans"]:
        if s["name"] in ("dock.dynamic", "dock.indicator"):
            assert by_id[s["parent"]]["name"] == "dock.render_async"
        if s["name"] == "dock.publish":
            assert by_id[s["parent"]]["name"] == "dock.dynamic"
        if s["name"] == "step.call":
            assert by_id[s["parent"]]["name"] == "dock.dynamic"


def test_fanout_and_skipped_frames(recorder):
    """A Dock's first frames and, with ``interleave`` 1, every other frame:
    the hub fan-out holds the hub's own probes, and a skipped frame is
    counted in its frame."""
    dock = Dock(DockConfig(), roi=ROIConfig(interleave=1, target_scale=2), device="cpu")
    for b in _planes(6):
        with profiler.span("frame"):
            dock.push_nv12(b[:H], b[H:])
            dock.render_async()
    snap = recorder.snapshot()
    by_id = {s["id"]: s for s in snap["spans"]}
    fanout = [s for s in snap["spans"] if s["name"] == "dock.fanout"]
    assert fanout
    kids = {s["name"] for s in snap["spans"] if s["parent"] in {f["id"] for f in fanout}}
    assert "render_target" in kids and any(k.startswith("surface_cb:") for k in kids)
    skipped = [c for c in snap["counts"] if c["name"] == "dock.skipped"]
    assert snap["counters"]["dock.skipped"] == len(skipped) == dock.hub.frames_skipped == 3
    frames = {s["fid"] for s in snap["spans"] if s["name"] == "frame"}
    assert len(frames) == 6 and {c["fid"] for c in skipped} <= frames
    assert all(by_id[c["span"]]["fid"] == c["fid"] for c in skipped)


@pytest.mark.parametrize("cause", ["queue.dropped_full", "queue.rejected_closed"])
def test_refused_pushes_count_by_cause(recorder, cause):
    """A full queue drops (the driver not started: nothing pops), a
    stopped driver's closed queue refuses; each counted under its cause,
    in the pushing frame."""
    drv, _ = _driver(depth=1)
    b = _planes(1)[0]
    if cause == "queue.dropped_full":
        assert drv.push_nv12(b[:H], b[H:])
    else:
        drv.start()
        drv.stop()
    assert not drv.push_nv12(b[:H], b[H:])
    assert not drv.push_nv12(b[:H], b[H:])
    snap = recorder.snapshot()
    assert snap["counters"] == {cause: 2}
    pushes = {s["fid"] for s in snap["spans"] if s["name"] == "producer.push_nv12"}
    assert {c["fid"] for c in snap["counts"]} <= pushes
    assert [c["name"] for c in snap["counts"]] == [cause, cause]


def test_full_ring_counts_lost_spans(monkeypatch, recorder):
    """A full ring keeps what it has, counts the rest, and does not grow;
    the summary's running totals still count every span."""
    monkeypatch.setattr(profiler, "CAPACITY", 8)
    profiler.reset()
    for _ in range(20):
        with profiler.span("outer"):
            pass
    profiler.count("a.counter", 3)
    snap = profiler.snapshot()
    assert len(snap["spans"]) == 8 and profiler._ring.n == 8
    assert snap["counters"] == {"profiler.spans_lost": 13, "a.counter": 3}
    assert snap["counts"] == []
    assert profiler.summary()["outer"]["count"] == 20


def test_off_records_nothing():
    """With the recorder off, frames through the driver and the Dock leave
    the snapshot empty, no thread gets the recorder's state, and no event
    pool is made."""
    profiler.enable(False)
    profiler.reset()
    threads, pools = len(profiler._threads), dict(profiler._pools)
    drv, panels = _driver()
    drv.start()
    try:
        _feed(drv, _planes(6))
    finally:
        drv.stop()
    assert len(panels) == 6
    snap = profiler.snapshot()
    assert (snap["spans"], snap["device"], snap["counts"], snap["counters"]) == ([], [], [], {})
    assert profiler.summary() == {}
    assert len(profiler._threads) == threads and profiler._pools == pools
    with profiler.span("x") as fid:
        assert fid is None
    assert profiler.enqueued() is None
    assert profiler.device_start(torch.device("cpu")) == -1


def test_spans_of_threads_do_not_mix(recorder):
    """Spans opened on several threads at once keep their own parents and
    frame ids."""
    barrier = threading.Barrier(4)

    def work():
        barrier.wait()
        for _ in range(50):
            with profiler.span("t.outer", profiler.NEW) as fid:
                with profiler.span("t.inner") as inner:
                    assert inner == fid

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    snap = recorder.snapshot()
    by_id = {s["id"]: s for s in snap["spans"]}
    inner = [s for s in snap["spans"] if s["name"] == "t.inner"]
    assert len(inner) == 200 and len({s["fid"] for s in inner}) == 200
    for s in inner:
        p = by_id[s["parent"]]
        assert p["name"] == "t.outer" and p["fid"] == s["fid"] and p["thread"] == s["thread"]
    assert profiler.summary()["t.outer"]["count"] == 200


# ---------------------------------------------------------------------------
# the benchmark's readers of the snapshot
# ---------------------------------------------------------------------------


def _span(i, name, fid, parent, t0, t1):
    return {"id": i, "name": name, "fid": fid, "parent": parent, "thread": 1, "t0": t0, "t1": t1}


def _synthetic() -> dict:
    """Two frames in the window [0, 1] and one after it: frame k's worker
    span from 0.1 + 0.2 k, a mouse call, the push, the render holding the
    settled route and its step call; the first frame's step also
    captured; an unresolved replay pair in the second frame."""
    spans, device, counts = [], [], []
    for k in range(3):
        b, i = 0.1 + 0.2 * k + (1.0 if k == 2 else 0.0), 10 * k
        spans += [_span(i, "queue.wait", k, None, b - 0.004, b - 0.001),
                  _span(i + 1, "pipeline_loop", k, None, b, b + 0.1),
                  _span(i + 2, "dock.mouse", k, i + 1, b, b + 0.001),
                  _span(i + 3, "dock.push_nv12", k, i + 1, b + 0.001, b + 0.003),
                  _span(i + 4, "dock.render_async", k, i + 1, b + 0.003, b + 0.013),
                  _span(i + 5, "dock.settled", k, i + 4, b + 0.004, b + 0.012),
                  _span(i + 6, "step.call", k, i + 5, b + 0.005, b + 0.011)]
        device += [{"name": "step.replay", "fid": k, "span": i + 6, "thread": 1, "t0": b + 0.006,
                    "t1": b + 0.007, "ms": None if k == 1 else 0.5},
                   {"name": "frame.device", "fid": k, "span": i + 1, "thread": 1, "t0": b,
                    "t1": b + 0.012, "ms": 1.0 + k}]
    counts.append({"name": "step.captures", "fid": 0, "span": 6, "thread": 1, "t": 0.107,
                   "n": 1.0})
    counts.append({"name": "step.captures", "fid": 2, "span": 26, "thread": 1, "t": 1.5,
                   "n": 1.0})
    return {"spans": spans, "device": device, "counts": counts,
            "counters": {"step.captures": 2}, "threads": {1: "color-monitor"}}


READINGS = {"queue_wait_ms": 3.0, "step_call_ms": 6.0, "dock_self_ms": 7.0,
            "replay_ms": 0.5, "frame_device_ms": 1.5, "recaptures": 1.0}


def _run(program):
    window = {"t0": 0.0, "t_end": 1.0}
    if program is not None:
        window["program"] = program
    return types.SimpleNamespace(window=window)


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_readers_on_a_synthetic_snapshot(metric):
    """Each reader's value on a known snapshot (records ending after the
    window left out; an unresolved event pair left out of the mean, not of
    the replays per frame), and None where there is nothing to read: no
    program snapshot (an untraced run, or a program without the recorder),
    or no frame in the window."""
    read = spec.reader(metric)
    assert read(_run(_synthetic())) == pytest.approx(READINGS[metric])
    assert read(_run(None)) is None
    empty = {"spans": [], "device": [], "counts": [], "counters": {}, "threads": {}}
    assert read(_run(empty)) is None


def test_readers_on_a_recorded_snapshot():
    """The readers on the CPU's own snapshot: the host spans give values,
    the device pairs (none made on the CPU) give None, and the Dock's self
    time and the step's add up to the Dock's spans."""
    try:
        snap = _traced_frames(4)
    finally:
        profiler.reset()
    run = types.SimpleNamespace(window={"t0": 0.0, "t_end": float("inf"), "program": snap})
    got = {m: spec.reader(m)(run) for m in READINGS}
    assert got["replay_ms"] is None and got["frame_device_ms"] is None
    assert got["recaptures"] == 0
    assert all(got[m] > 0 for m in ("queue_wait_ms", "step_call_ms", "dock_self_ms"))
    tops = [s for s in snap["spans"] if s["name"] in ("dock.push_nv12", "dock.render_async")]
    assert (got["dock_self_ms"] + got["step_call_ms"]) * 4 == pytest.approx(
        sum(bench_spans.ms(s) for s in tops))


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_event_pairs_resolve_and_captures_count(cuda):
    """On a card: after a flush every frame's replay and frame event pairs
    resolve, the frame's time holds its replay's; ``step.captures`` counts
    one capture per new signature and none on a replay, and
    ``step.evictions`` each graph dropped for a new one."""
    try:
        snap = _traced_frames(6, cuda)
        profiler.reset()
        profiler.enable(True)
        step = captured(lambda x: x * 2, cuda, max_graphs=1)
        a, b = torch.ones(8, device=cuda), torch.ones(16, device=cuda)
        for x in (a, a, b, b, a):
            step(x)
        torch.cuda.synchronize(cuda)
        counted = profiler.snapshot()
    finally:
        profiler.enable(False)
        profiler.reset()
    assert "step.captures" not in snap["counters"]  # the warm-up captured
    pairs: dict = {}
    for d in snap["device"]:
        assert d["ms"] is not None and d["ms"] > 0, d
        pairs.setdefault(d["fid"], {})[d["name"]] = d["ms"]
    assert len(pairs) == 6
    for p in pairs.values():
        assert set(p) == {"step.replay", "frame.device"}
        assert p["frame.device"] >= p["step.replay"]
    assert counted["counters"] == {"step.captures": 3, "step.evictions": 2}
    names = [s["name"] for s in counted["spans"]]
    assert (names.count("step.capture"), names.count("step.fill"),
            names.count("step.replay"), names.count("step.call")) == (3, 2, 5, 5)
    assert len(counted["device"]) == 5 and all(d["ms"] is not None for d in counted["device"])
