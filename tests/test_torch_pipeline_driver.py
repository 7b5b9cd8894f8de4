"""The port's host pipeline (``obs_color_monitor_tpu_torch.pipeline``):
queue, driver, profiler and capture targets on the CPU.

The cases of ``tests/test_models_pipeline.py`` (its queue, driver and
profiler cases) and ``tests/test_targets.py``, run on the port; then a JAX
driver-fed Dock and a port driver-fed Dock on the same frames, RGBA and
NV12, give equal panels and equal published statistics (exact).  The
histogram uses PIXEL levels: JAX's CPU render leaves a pixel empty at an
exact AUTO-level tie where the port (and golden) fill it
(``tests/test_torch_dynamic_roi.py::test_histogram_tie_follows_golden``)."""

import logging
import time

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu import config as J
from obs_color_monitor_tpu import models as jm
from obs_color_monitor_tpu import pipeline as jp
from obs_color_monitor_tpu_torch import golden
from obs_color_monitor_tpu_torch.config import (
    Components,
    DockConfig,
    HistogramConfig,
    ROIConfig,
    from_reference,
)
from obs_color_monitor_tpu_torch.models import CaptureHub, Dock, Histogram
from obs_color_monitor_tpu_torch.pipeline import (
    PROGRAM,
    FrameQueue,
    NV12Frame,
    PipelineDriver,
    TargetDirectory,
    TargetedPipeline,
    profiler,
)
from obs_color_monitor_tpu_torch.runtime import native

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def frame(rng):
    f = rng.integers(0, 256, size=(48, 64, 4), dtype=np.uint8)
    f[..., 3] = 255
    return f


def _hist(**kw):
    return Histogram(HistogramConfig(target_scale=1, **kw), device=CPU)


def _stream_dock():
    return Dock(DockConfig(show_roi=False), roi=ROIConfig(interleave=0, target_scale=1),
                device=CPU)


# ---------------------------------------------------------------------------
# queue and driver (tests/test_models_pipeline.py)
# ---------------------------------------------------------------------------


def test_queue_drop_on_full():
    q = FrameQueue(depth=3)
    assert q.push(1) and q.push(2) and q.push(3)
    assert not q.push(4)  # dropped
    assert q.n_dropped == 1
    assert q.pop() == 1
    assert q.push(4)


def test_pipeline_driver(frame):
    his = _hist()
    drv = PipelineDriver(his._hub)
    drv.start()
    try:
        for _ in range(5):
            drv.push_frame(frame)
            time.sleep(0.01)
        drv.flush()
    finally:
        drv.stop()
    s = drv.stats
    assert s["processed"] >= 1
    assert s["pushed"] + s["dropped"] == 5 or s["pushed"] == 5
    want = golden.histogram_counts(golden.downscale(frame, 1), None, Components.RGB)
    np.testing.assert_array_equal(his.counts(), want)


def _count_fanout(dock, calls):
    orig = dock.hub.process

    def counting(frame_, *a, **k):
        calls.append(1)
        return orig(frame_, *a, **k)

    dock.hub.process = counting


def test_driver_fed_dock_rides_stream_route(rng):
    """A driver-fed Dock consumes through the settled route: in steady
    state the hub fan-out never runs, the settled stream step is built once,
    every panel reaches on_panel in order, and panels and published
    statistics equal a directly driven dock on the same frames."""
    frames = []
    for _ in range(8):
        f = rng.integers(0, 256, size=(48, 96, 4), dtype=np.uint8)
        f[..., 3] = 255
        frames.append(f)
    dock = _stream_dock()
    panels = []
    drv = PipelineDriver(dock=dock, on_panel=lambda p: panels.append(p.numpy()))
    n_fanout = []
    drv.start()
    try:
        for f in frames[:3]:  # warm-up: the layout and the settled step
            assert drv.push_frame(f)
            drv.flush()
        settled = dock._settled
        _count_fanout(dock, n_fanout)
        for f in frames[3:]:
            assert drv.push_frame(f)
            drv.flush()
    finally:
        drv.stop()
        dock.hub.__dict__.pop("process", None)
    assert n_fanout == []
    assert settled is not None and dock._settled is settled  # built once
    assert dock.hub.frames_processed == 8
    assert drv.stats["processed"] == 8 and drv.stats["errors"] == 0
    assert len(panels) == 8

    ref = _stream_dock()
    for i, f in enumerate(frames):
        ref.push_frame(f)
        np.testing.assert_array_equal(panels[i], ref.render_async().numpy(), err_msg=f"frame {i}")
    np.testing.assert_array_equal(dock.histogram.counts(), ref.histogram.counts())
    np.testing.assert_array_equal(dock.waveform.counts(), ref.waveform.counts())


def test_driver_requires_exactly_one_consumer():
    with pytest.raises(ValueError, match="exactly one"):
        PipelineDriver()
    with pytest.raises(ValueError, match="exactly one"):
        PipelineDriver(CaptureHub(ROIConfig(), CPU), dock=Dock(device=CPU))


def test_driver_push_nv12_rides_stream_route(rng):
    """Wire-format frames through the driver: push_nv12 stages the planes
    on the producer thread; the worker consumes through the dock's NV12
    deferral, whose settled step decodes inside it (no decode outside it in
    steady state); panels equal a hand-driven dock.push_nv12."""
    from obs_color_monitor_tpu_torch.models import base

    H, W = 48, 96
    bufs = [rng.integers(0, 256, (H * 3 // 2, W), dtype=np.uint8) for _ in range(6)]
    dock = _stream_dock()
    panels = []
    drv = PipelineDriver(dock=dock, on_panel=lambda p: panels.append(p.numpy()))
    decode_calls = []
    orig_decode = base.nv12_to_packed
    drv.start()
    try:
        for b in bufs[:3]:
            assert drv.push_nv12(b[:H], b[H:])
            drv.flush()
        settled = dock._settled
        base.nv12_to_packed = lambda *a, **k: (decode_calls.append(1), orig_decode(*a, **k))[1]
        for b in bufs[3:]:
            assert drv.push_nv12(b[:H], b[H:])
            drv.flush()
    finally:
        drv.stop()
        base.nv12_to_packed = orig_decode
    assert decode_calls == []  # no hub fan-out decode: the settled step's own
    assert len(panels) == 6
    assert dock._settled is settled
    assert dock.hub.frames_processed == 6

    ref = _stream_dock()
    for i, b in enumerate(bufs):
        ref.push_nv12(b[:H], b[H:])
        np.testing.assert_array_equal(panels[i], ref.render_async().numpy(), err_msg=f"frame {i}")
    np.testing.assert_array_equal(dock.histogram.counts(), ref.histogram.counts())


def test_driver_hub_mode_push_nv12(rng):
    """push_nv12 in bare-hub mode decodes through hub.process_nv12 and
    publishes exact statistics (native decoder twin)."""
    H, W = 24, 48
    b = rng.integers(0, 256, (H * 3 // 2, W), dtype=np.uint8)
    his = _hist()
    drv = PipelineDriver(his._hub)
    drv.start()
    try:
        assert drv.push_nv12(b[:H], b[H:])
        drv.flush()
    finally:
        drv.stop()
    rgba = native.nv12_to_rgba(b[:H], b[H:], cs=int(his._hub.colorspace))
    want = golden.histogram_counts(rgba, None, Components.RGB)
    np.testing.assert_array_equal(his.counts(), want)


def test_driver_push_nv12_rejects_native_queue():
    his = Histogram(HistogramConfig(), device=CPU)
    drv = PipelineDriver(his._hub, native_queue_shape=(16, 32))
    with pytest.raises(ValueError, match="native"):
        drv.push_nv12(np.zeros((16, 32), np.uint8), np.zeros((8, 32), np.uint8))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_driver_push_nv12_stages_on_producer_side(rng, dtype):
    """push_nv12 makes the planes tensors on the hub's device BEFORE the
    frame enters the queue (the reference's graphics-thread staging,
    common.c:335-403): the queued NV12Frame holds tensors, not numpy, with
    the bytes pushed, and owns them (a producer that reuses its buffer does
    not change a queued frame); on the CPU no event is attached."""
    H, W = 16, 32
    b = rng.integers(0, 1024, (H * 3 // 2, W)).astype(dtype)
    want = b.copy()
    his = Histogram(HistogramConfig(), device=CPU)
    drv = PipelineDriver(his._hub)  # not started: the frame stays queued
    assert drv.push_nv12(b[:H], b[H:], shift=6 if dtype == np.uint16 else 0)
    b[:] = 0  # the producer reuses its buffer
    queued = drv.queue.pop(timeout=1.0)
    assert isinstance(queued, NV12Frame)
    assert isinstance(queued.y, torch.Tensor) and isinstance(queued.uv, torch.Tensor)
    assert queued.y.device.type == "cpu" and queued.ready is None
    assert queued.shift == (6 if dtype == np.uint16 else 0)
    np.testing.assert_array_equal(queued.y.numpy(), want[:H])
    np.testing.assert_array_equal(queued.uv.numpy(), want[H:])


def test_driver_push_nv12_rejects_bad_planes():
    drv = PipelineDriver(Histogram(HistogramConfig(), device=CPU)._hub)
    with pytest.raises(ValueError, match="NV12 planes"):
        drv.push_nv12(np.zeros((16, 32), np.uint8), np.zeros((8, 30), np.uint8))
    with pytest.raises(ValueError, match="NV12 planes"):
        drv.push_nv12(np.zeros((16, 32), np.uint8), np.zeros((8, 32), np.uint16))
    assert drv.queue.n_pushed == 0


def test_profiler_probes(frame):
    """Probe names mirror the reference's ENABLE_PROFILE sections
    (src/common.c:10-21)."""
    profiler.reset()
    profiler.enable(True)
    try:
        his = _hist()
        his.push_frame(frame)
        s = profiler.summary()
        assert "render_target" in s
        assert s["render_target"]["count"] == 1
        assert any(k.startswith("surface_cb:") for k in s)
    finally:
        profiler.enable(False)
        profiler.reset()
    his.push_frame(frame)  # disabled: nothing recorded
    assert profiler.summary() == {}


def test_profiler_trace_writes_chrome_trace(tmp_path, frame):
    """start_trace/stop_trace wrap a torch.profiler profile and write a
    Chrome trace holding the probes' spans."""
    profiler.enable(True)
    try:
        profiler.start_trace(str(tmp_path / "trace"))
        with pytest.raises(RuntimeError, match="already"):
            profiler.start_trace(str(tmp_path / "other"))
        _hist().push_frame(frame)
        path = profiler.stop_trace()
    finally:
        profiler.enable(False)
        profiler.reset()
    assert path.exists() and "render_target" in path.read_text()
    with pytest.raises(RuntimeError, match="no trace"):
        profiler.stop_trace()


def test_driver_survives_consumer_exception(frame, caplog):
    """A failing consumer drops the frame but keeps the pipeline alive."""

    class Bomb(Histogram):
        def __init__(self):
            super().__init__(HistogramConfig(target_scale=1), device=CPU)
            self.calls = 0

        def surface_cb(self, surface):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("boom")
            super().surface_cb(surface)

    bomb = Bomb()
    drv = PipelineDriver(bomb._hub)
    drv.start()
    try:
        with caplog.at_level(logging.ERROR, "obs_color_monitor_tpu_torch.pipeline"):
            for _ in range(3):
                drv.push_frame(frame)
                time.sleep(0.05)
            drv.flush()
    finally:
        drv.stop()
    assert drv.n_errors >= 1
    assert bomb.calls >= 2  # thread kept going after the failure
    assert "pipeline frame failed" in caplog.text


def test_pipeline_driver_restart(frame):
    """stop() then start() must process frames again (a restarted driver
    gets a fresh queue — the closed one rejects every push forever)."""
    his = _hist()
    drv = PipelineDriver(his._hub)
    drv.start()
    try:
        assert drv.push_frame(frame)
        drv.flush()
        n1 = drv.hub.frames_processed
        assert n1 >= 1
        drv.stop()
        assert not drv.push_frame(frame)  # closed queue drops
        drv.start()
        assert drv.push_frame(frame)  # fresh queue accepts again
        drv.flush()
        assert drv.hub.frames_processed > n1
    finally:
        drv.stop()


def test_driver_dock_mode_restart(rng):
    """A restarted dock-mode driver keeps serving the settled route: the
    settled step survives stop()/start() (it is dock state, not driver
    state), panels keep flowing to on_panel, and frame counting continues."""
    f = rng.integers(0, 256, size=(48, 96, 4), dtype=np.uint8)
    f[..., 3] = 255
    dock = _stream_dock()
    panels = []
    drv = PipelineDriver(dock=dock, on_panel=panels.append)
    drv.start()
    try:
        for _ in range(3):
            assert drv.push_frame(f)
            drv.flush()
        settled = dock._settled
        drv.stop()
        assert not drv.push_frame(f)  # closed queue drops
        drv.start()
        assert drv.push_frame(f)
        drv.flush()
    finally:
        drv.stop()
    assert len(panels) == 4
    assert dock.hub.frames_processed == 4
    assert settled is not None and dock._settled is settled  # no rebuild


def test_pipeline_driver_flush_counts_inflight(frame):
    """flush() waits for frames the worker has POPPED but not yet finished
    (the queue-length check alone can't see them)."""
    his = _hist()
    drv = PipelineDriver(his._hub)
    drv.start()
    try:
        for _ in range(4):
            drv.push_frame(frame)
        drv.flush()
        assert drv._consumed == drv.queue.n_pushed
        assert drv.hub.frames_processed + drv.hub.frames_skipped == drv._consumed
    finally:
        drv.stop()


def test_driver_process_now_and_native_queue(frame):
    """process_now runs one frame synchronously; a native fixed-shape queue
    carries packed frames to the worker."""
    his = _hist()
    drv = PipelineDriver(his._hub, native_queue_shape=frame.shape)
    drv.process_now(frame)
    assert his._hub.frames_processed == 1
    drv.start()
    try:
        assert drv.push_frame(frame)
        drv.flush()
    finally:
        drv.stop()
    assert his._hub.frames_processed == 2 and drv.stats["errors"] == 0
    want = golden.histogram_counts(frame, None, Components.RGB)
    np.testing.assert_array_equal(his.counts(), want)


def test_driver_stress_many_producers(frame):
    """More producer threads than cores, with a short switch interval:
    every push is either accepted or dropped, and every accepted frame is
    consumed exactly once (no lost update in the counters)."""
    import sys
    import threading

    his = _hist()
    drv = PipelineDriver(his._hub, queue_depth=2)
    small = frame[:8, :16].copy()
    results = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    drv.start()
    try:
        def produce():
            results.extend(drv.push_frame(small) for _ in range(25))

        threads = [threading.Thread(target=produce) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        drv.flush(timeout=30)
    finally:
        drv.stop()
        sys.setswitchinterval(old)
    s = drv.stats
    assert len(results) == 300
    assert s["pushed"] == sum(results) and s["pushed"] + s["dropped"] == 300
    assert drv._consumed == s["pushed"] == his._hub.frames_processed


# ---------------------------------------------------------------------------
# capture targets (tests/test_targets.py)
# ---------------------------------------------------------------------------


def _mk(rng):
    f = rng.integers(0, 256, (24, 32, 4), dtype=np.uint8)
    f[..., 3] = 255
    return f


def _target_hub():
    hub = CaptureHub(ROIConfig(target_scale=1, interleave=0), CPU)
    hub.register(_hist())
    return hub


def test_program_channel_always_exists():
    d = TargetDirectory()
    assert d.get(PROGRAM) is not None
    assert d.names()[0] == PROGRAM
    with pytest.raises(ValueError):
        d.remove(PROGRAM)


def test_targeted_pipeline_by_name(rng):
    d = TargetDirectory()
    cam = d.create("camera 1")
    tp = TargetedPipeline(_target_hub(), d, "camera 1")
    assert tp.tick() is False  # no frame yet
    cam.push(_mk(rng))
    assert tp.tick() is True
    assert tp.tick() is False  # same frame not reprocessed
    cam.push(_mk(rng))
    assert tp.tick() is True


def test_dangling_target_idles_then_recovers(rng):
    """Removed source -> no error, no frames; reappearing -> resumes
    (reference weak-ref recheck, src/common.c:498-526)."""
    d = TargetDirectory()
    cam = d.create("cam")
    tp = TargetedPipeline(_target_hub(), d, "cam")
    cam.push(_mk(rng))
    assert tp.tick() is True
    d.remove("cam")
    assert tp.tick() is False  # dangling: idle
    cam2 = d.create("cam")  # same name reappears
    cam2.push(_mk(rng))
    assert tp.tick() is True


def test_retarget(rng):
    d = TargetDirectory()
    a, b = d.create("a"), d.create("b")
    tp = TargetedPipeline(_target_hub(), d, "a")
    a.push(_mk(rng))
    b.push(_mk(rng))
    assert tp.tick() is True
    tp.set_target("b")
    assert tp.tick() is True  # picks up b's frame
    assert d.names() == ["", "a", "b"]


def test_program_push(rng):
    d = TargetDirectory()
    tp = TargetedPipeline(_target_hub(), d)  # default: program
    d.program.push(_mk(rng))
    assert tp.tick() is True


def test_targeted_pipeline_counts_match_jax(rng):
    """The same frames through a JAX and a port TargetedPipeline publish
    equal histograms."""
    jhub = jm.CaptureHub(J.ROIConfig(target_scale=1, interleave=0))
    jhis = jm.Histogram(J.HistogramConfig(target_scale=1))
    jhub.register(jhis)
    jdir, tdir = jp.TargetDirectory(), TargetDirectory()
    thub = _target_hub()
    pipes = [(jdir.create("cam"), jp.TargetedPipeline(jhub, jdir, "cam")),
             (tdir.create("cam"), TargetedPipeline(thub, tdir, "cam"))]
    for _ in range(2):
        f = _mk(rng)
        for cam, tp in pipes:
            cam.push(f)
            assert tp.tick() is True
    np.testing.assert_array_equal(thub.consumers[0].counts(), np.asarray(jhis.counts()))


# ---------------------------------------------------------------------------
# the port's driver-fed Dock against JAX's (exact)
# ---------------------------------------------------------------------------


def _pixel_docks():
    kw = dict(config=J.DockConfig(show_roi=True, show_focuspeaking=True),
              roi=J.ROIConfig(target_scale=2, interleave=0),
              histogram=J.HistogramConfig(level_mode=J.LevelMode.PIXEL))
    return jm.Dock(**kw), Dock(**{k: from_reference(v) for k, v in kw.items()}, device=CPU)


def _drive(pkg_driver, dock, frames, nv12):
    panels = []
    drv = pkg_driver(dock=dock, on_panel=lambda p: panels.append(np.asarray(p)))
    drv.start()
    try:
        for f in frames:
            assert drv.push_nv12(*f) if nv12 else drv.push_frame(f)
            drv.flush()
    finally:
        drv.stop()
    assert drv.stats["errors"] == 0 and drv.stats["processed"] == len(frames)
    return panels


@pytest.mark.parametrize("fmt", ["rgba", "nv12"])
def test_driver_fed_dock_matches_jax(rng, fmt):
    """8 frames through a JAX driver-fed Dock and the port's: every panel,
    the published vectorscope, waveform and histogram equal."""
    H, W = 48, 96
    if fmt == "nv12":
        frames = []
        for _ in range(8):
            b = rng.integers(0, 256, (H * 3 // 2, W), dtype=np.uint8)
            frames.append((b[:H], b[H:]))
    else:
        frames = []
        for _ in range(8):
            f = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
            f[..., 3] = np.where(rng.random((H, W)) < 0.05, 0, 255)
            frames.append(f)
    jd, td = _pixel_docks()
    jpanels = _drive(jp.PipelineDriver, jd, frames, fmt == "nv12")
    tpanels = _drive(PipelineDriver, td, frames, fmt == "nv12")
    assert len(jpanels) == len(tpanels) == 8
    for i, (a, b) in enumerate(zip(jpanels, tpanels)):
        np.testing.assert_array_equal(b, a, err_msg=f"frame {i}")
    np.testing.assert_array_equal(td.histogram.counts(), np.asarray(jd.histogram.counts()))
    np.testing.assert_array_equal(td.waveform.counts(), np.asarray(jd.waveform.counts()))
    np.testing.assert_array_equal(td.vectorscope._read().numpy(),
                                  np.asarray(jd.vectorscope._read()))
    assert td.hub.frames_processed == jd.hub.frames_processed == 8
    assert td._settled is not None


def test_driver_hub_mode_matches_jax(rng):
    """A hub-mode driver on RGBA and NV12 pushes: the port's published
    histogram and vectorscope equal JAX's."""
    H, W = 24, 48
    b = rng.integers(0, 256, (H * 3 // 2, W), dtype=np.uint8)
    f = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    outs = []
    for side in ("jax", "port"):
        if side == "jax":
            hub = jm.CaptureHub(J.ROIConfig(target_scale=1, interleave=0))
            his, vs = jm.Histogram(J.HistogramConfig()), jm.Vectorscope(J.VectorscopeConfig())
            drv = jp.PipelineDriver(hub)
        else:
            hub = CaptureHub(ROIConfig(target_scale=1, interleave=0), CPU)
            his = Histogram(HistogramConfig(), device=CPU)
            from obs_color_monitor_tpu_torch.models import Vectorscope

            vs = Vectorscope(device=CPU)
            drv = PipelineDriver(hub)
        hub.register(his)
        hub.register(vs)
        got = []
        drv.start()
        try:
            for push in (lambda: drv.push_frame(f), lambda: drv.push_nv12(b[:H], b[H:])):
                assert push()
                drv.flush()
                got += [np.asarray(his.counts()), np.asarray(vs._read())]
        finally:
            drv.stop()
        outs.append(got)
    for a, b_ in zip(*outs):
        np.testing.assert_array_equal(b_, a)
