"""A frame the driver refuses is owed no panel; one it took is.

Run on the CPU, at a tiny frame size, from the repository's root:

    python3 -m pytest bench_torch/tests -q

- a checked frame that the driver refuses on a full queue (its push
  returns False, as the reference's graphics thread drops a frame) is
  never consumed: the run stays correct on every cell, the interleave's
  count included, the refusal counts as failed, and the next frame offered
  is checked in its place, so the check loses no frame;
- a checked frame that the driver took and whose panel never reaches the
  host (the dock raises on it) is missing, and the run is not correct.
"""

from __future__ import annotations

import re

import pytest
import torch

from bench_torch import run, spec
from bench_torch.traffic import generator

torch.set_num_threads(2)

SEED = 3
CHECKED = 4  # of the tiny window's 12 frames, so that a refused one has a frame to pass to


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _run(bench, name, seconds=3.0):
    cell = spec.workload(bench, name)
    cfg, traffic = run.tiny(bench, cell)
    traffic = {**traffic, "checked_frames": CHECKED}
    n_plan = generator.plan(traffic, seconds)
    first = min(generator.sample(traffic, SEED, 0, 1, n_plan))
    return cell, cfg, traffic, traffic["warmup_frames"] + first


@pytest.mark.parametrize("name", ["uhd60.settled", "uhd60.drag", "screen1440.settled",
                                  "uhd60.interleave1"])
def test_refused_checked_frame_is_not_owed(bench, monkeypatch, capsys, name):
    from obs_color_monitor_tpu_torch.pipeline import PipelineDriver

    cell, cfg, traffic, refuse = _run(bench, name)
    push = PipelineDriver.push_nv12
    calls = []

    def full_queue(self, *a, **k):
        calls.append(None)
        return False if len(calls) - 1 == refuse else push(self, *a, **k)

    monkeypatch.setattr(PipelineDriver, "push_nv12", full_queue)
    res = run.measure(bench, cell, SEED, 3.0, False, "cpu", cfg, traffic)
    said = re.search(r"checked (\d+) of (\d+) sampled frames .*: (\d+) analysed, (\d+) skipped; "
                     r".*: (\d+), with no frame left to take it: (\d+)", capsys.readouterr().err)
    assert res["correct"] and said, res["checks"]
    checked, sampled, _, _, refused, unplaced = map(int, said.groups())
    assert (checked, sampled, refused, unplaced) == (CHECKED, CHECKED, 1, 0)
    assert res["failed"] == 1


def test_taken_frame_that_never_lands_is_missing(bench, monkeypatch):
    from obs_color_monitor_tpu_torch.models import dock

    cell, cfg, traffic, fail = _run(bench, "uhd60.interleave1")
    push = dock.Dock.push_nv12
    calls = []

    def raises(self, *a, **k):
        calls.append(None)
        if len(calls) - 1 == fail:
            raise RuntimeError("a frame the dock took and lost")
        return push(self, *a, **k)

    monkeypatch.setattr(dock.Dock, "push_nv12", raises)
    res = run.measure(bench, cell, SEED, 3.0, False, "cpu", cfg, traffic)
    assert not res["correct"] and res["checks"]["missing"]["value"] == 1, res["checks"]
