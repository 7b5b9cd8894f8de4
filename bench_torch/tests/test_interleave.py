"""The check follows the hub's interleave, and changes nothing at interleave 0.

Run on the CPU, at a tiny frame size, from the repository's root:

    python3 -m pytest bench_torch/tests -q

- on ``uhd60.interleave1`` a dock that analyses every frame (its interleave
  ignored) reads not correct, on ``route_off`` and on the panel bytes, and
  so does a dock that counts its skips but shows a skipped frame's own
  capture;
- at interleave 0 the check gives, on the three other cells, the numbers
  that it gave before it followed the interleave (``_before``, a copy of
  that check), on runs with half of each frame left out, where they are
  not 0;
- ``step_roofline``'s bytes are unchanged at interleave 0;
- the seeds run on the chip sample analysed and skipped frames both, and
  a sound run checks both kinds.
"""

from __future__ import annotations

import re

import pytest
import torch

from bench_torch import check, serve, spec
from bench_torch.metrics import step_roofline
from bench_torch.tests.test_correctness import _measure, _patch_analyze
from bench_torch.traffic import generator

torch.set_num_threads(2)

CELL = "uhd60.interleave1"
# the seeds of uhd60.interleave1's runs and control on the chip
CHIP_SEEDS = [2800180001, 2800180002, 2800180003, *range(2800180101, 2800180107),
              2800180111, 2800180112, 2800180113, 2800180121, 2800180122, 2800180123,
              2800180141, 2800180142, 1745960201, *range(2800180201, 2800180209),
              2800180211, 2800180212]


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_rule_of_the_interleave():
    assert [check.sources(j, 0) for j in range(4)] == [(0, 0), (1, 0), (2, 1), (3, 2)]
    assert [check.sources(j, 1) for j in range(6)] == [(0, 0), (0, 0), (2, 0), (2, 2), (4, 2),
                                                       (4, 4)]
    assert [check.analysed(j, 1) for j in range(4)] == [True, False, True, False]


def test_every_frame_analysed_is_not_correct(bench, monkeypatch):
    build = serve.build_dock

    def every_frame(cfg, rect, device):
        dock = build(cfg, rect, device)
        dock.hub.config.interleave = 0
        return dock

    monkeypatch.setattr(serve, "build_dock", every_frame)
    res = _measure(bench, CELL)
    assert not res["correct"]
    assert res["checks"]["route_off"]["value"] > 0
    assert res["checks"]["panel_bytes_off"]["value"] > 0


def test_skipped_frame_showing_its_own_capture_is_not_correct(bench, monkeypatch):
    from obs_color_monitor_tpu_torch.models import dock

    consume = dock.Dock._consume_stream

    def own_capture(self, cx, cy, shown):
        frame, hub = self._pending, self.hub
        skipping = hub._i_interleave != 0 and hub.config.interleave > 0
        panel = consume(self, cx, cy, shown)
        if skipping:  # counted as skipped, then analysed and published all the same
            n, hub.config.interleave = hub.config.interleave, 0
            try:
                self._hub_process(frame)
            finally:
                hub.config.interleave = n
        return panel

    monkeypatch.setattr(dock.Dock, "_consume_stream", own_capture)
    res = _measure(bench, CELL)
    assert not res["correct"]
    assert res["checks"]["panel_bytes_off"]["value"] > 0
    assert res["checks"]["route_off"]["value"] == 0


def _before(cell, window, device) -> dict:
    """The check's numbers as it computed them before it followed the
    interleave: panel j shows frame j, its waveform row frame j - 1."""
    nums = dict.fromkeys(check.LIMITS, 0)
    expect = check.Expect(cell, device)
    ref = expect.ref
    tms = check.clock(max(len(s.consumed) for s in cell.streams))
    for s in cell.streams:
        for rec in s.records:
            if not (rec.window and rec.sampled):
                continue
            if rec.t_landed is None:
                nums["missing"] += 1
                continue
            j = rec.consumed
            prev = s.consumed[j - 1].pool if j > 0 else rec.pool
            cur = expect.frame(s.k, rec.pool)
            if cell.drag is not None and j >= cell.drag.press_at:
                rect = cell.drag.rect(j)
                want = (ref.dynamic_panel(cur.capture, rect, tms[j]),
                        ref.rect_stats(cur.capture, rect))
            else:
                want = ref.settled_panel(cur, expect.frame(s.k, prev), tms[j]), cur
            for k, v in check.compare(want, rec.panel.numpy(), rec.stats, expect.dev).items():
                nums[k] += v
    landed = [r for s in cell.streams for r in s.records if r.window and r.t_landed is not None]
    expected = len(landed) if cell.drag is not None else 0
    nums["route_off"] = abs(sum(1 for r in landed if r.dynamic) - expected)
    return nums


@pytest.mark.parametrize("name", ["uhd60.settled", "uhd60.drag", "screen1440.settled"])
def test_interleave_0_checks_as_before(bench, monkeypatch, name):
    seen = []
    new = check.check

    def both(cell, window, device):
        got = new(cell, window, device)
        seen.append(({k: v for k, (v, _) in got["numbers"].items()}, _before(cell, window, device),
                     got["skipped"]))
        return got

    def half(analyze):
        def f(x, *a, **k):
            return analyze(x[: x.shape[0] // 2], *a, **k)
        return f

    _patch_analyze(monkeypatch, half)
    monkeypatch.setattr(check, "check", both)
    _measure(bench, name)
    (now, before, skipped), = seen
    assert now == before and before["panel_bytes_off"] > 0 and skipped == 0


@pytest.mark.parametrize("name, nbytes", [("obs_uhd60_nv12_dock", 17130496),
                                          ("obs_qhd60_screen_dock", 9726976)])
def test_frame_bytes_at_interleave_0_are_unchanged(bench, name, nbytes):
    assert step_roofline.frame_bytes(spec.config(bench, name)) == nbytes


def test_frame_bytes_at_interleave_1_are_the_cycle_mean(bench):
    cfg = spec.config(bench, spec.workload(bench, CELL)["config"])
    skipped = 1920 * 1080 * 4 + 256 * 256 + 3 * 256 * 1920 + 3 * 256 * 4 + 512 * 1536 * 4
    assert step_roofline.frame_bytes(cfg) == (17130496 + skipped) / 2


def test_chip_seeds_sample_both_kinds(bench):
    cell = spec.workload(bench, CELL)
    t = generator.load(cell["traffic"])
    n = spec.config(bench, cell["config"])["roi"]["interleave"]
    n_plan = generator.plan(t, bench["run_seconds"])
    for seed in CHIP_SEEDS:
        js = [t["warmup_frames"] + i for i in generator.sample(t, seed, 0, 1, n_plan)]
        kinds = [check.analysed(j, n) for j in js]
        assert 0 < sum(kinds) < len(kinds), seed


def test_sound_run_checks_both_kinds(bench, capsys):
    res = _measure(bench, CELL)
    said = re.search(r"checked (\d+) of \d+ sampled frames .*: (\d+) analysed, (\d+) skipped",
                     capsys.readouterr().err)
    assert res["correct"] and said, res["checks"]
    checked, analysed, skipped = map(int, said.groups())
    assert analysed > 0 and skipped > 0 and analysed + skipped == checked
