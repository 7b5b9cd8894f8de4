"""Smoke-run every example of the port as a subprocess on the CPU at 64x48
(``python -m obs_color_monitor_tpu_torch.examples.<name> --device cpu``),
checking the markers each prints to show its path ran, as
``tests/test_examples.py`` does for the JAX package's examples."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _run(name: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", f"obs_color_monitor_tpu_torch.examples.{name}", *args],
        capture_output=True, timeout=300, env=env, cwd=str(REPO))
    out = r.stdout.decode(errors="replace") + r.stderr.decode(errors="replace")
    assert r.returncode == 0, f"{name} failed:\n{out[-4000:]}"
    return out


def test_interactive_roi_drag():
    out = _run("interactive_roi_drag", "--device", "cpu", "--size", "64x48", "--steps", "3")
    # one dynamic step for the whole drag, the same operations for every rect
    assert "dynamic-rect steps built for the drag: 1" in out, out[-2000:]
    assert "dynamic-rect op sequences for the drag: 1" in out, out[-2000:]
    assert "full capture: mean level" in out


def test_multistream_serving():
    out = _run("multistream_serving", "--streams", "4", "--size", "64x48", "--frames", "2",
               "--device", "cpu")
    assert "mesh: 1 rank on cpu" in out, out[-2000:]
    assert "stream 3" in out  # per-stream summaries printed for all streams


def test_p010_wire_ingest():
    out = _run("p010_wire_ingest", "--size", "64x48", "--frames", "2", "--device", "cpu")
    assert "OK" in out, out[-2000:]
    # P010: MSB-aligned in 16-bit words -> the monitoring domain is >> 8
    assert "device shift=8" in out


def test_driver_pipeline():
    out = _run("driver_pipeline", "--device", "cpu", "--size", "64x48", "--frames", "6")
    assert "DRIVER_PIPELINE_OK" in out, out[-2000:]
    assert "'errors': 0" in out and "frames pushed 6, processed 6" in out


def test_driver_pipeline_nv12_retries_a_full_queue():
    # a queue of one on a slow CPU worker: pushes are rejected and retried,
    # and every frame is still processed
    out = _run("driver_pipeline", "--device", "cpu", "--nv12", "--size", "64x48",
               "--frames", "6", "--queue-depth", "1")
    assert "DRIVER_PIPELINE_OK" in out, out[-2000:]
    assert "frames pushed 6, processed 6" in out


def test_multihost_distributed_simulate():
    out = _run("multihost_distributed", "--simulate", "--ranks", "2", "--size", "64x48",
               "--streams_per_host", "1")
    for r in range(2):
        assert f"host {r}/2: cpu, batch 1 local of 2 global" in out, out[-2000:]
        assert f"MULTIHOST_OK rank {r}" in out
    assert "vectorscope occupied bins per local stream" in out
    assert "(= 64x48: True)" in out


def test_examples_need_a_card_unless_told_otherwise():
    # without a card the default device is refused (exit 2), never the CPU
    import torch

    if torch.cuda.is_available():
        return
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m",
                        "obs_color_monitor_tpu_torch.examples.p010_wire_ingest",
                        "--size", "64x48", "--frames", "1"], capture_output=True, timeout=120,
                       env=env, cwd=str(REPO))
    assert r.returncode == 2 and b"--device cpu" in r.stderr
