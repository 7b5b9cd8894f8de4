"""The benchmark's correctness check has to fail what it is there to catch.

Run on the CPU, at a tiny frame size, from the repository's root:

    python3 -m pytest bench_torch/tests -q

- the control: the plain reference with its capture computed in bfloat16
  (the nearest precision below the float32 the capture spec states), put
  in the program's place, differs from the float32 reference;
- a whole run (set-up, window, sink, comparison) through the program's
  plain versions comes out correct, and comes out not correct with the
  timed path broken underneath it: a step that returns its state unchanged
  (the first frame's outputs for every frame), half of each frame left out
  of the analysis, and one answer altered where it is produced (a
  vectorscope count).  The cells take one chip, so there is no exchange
  between chips to leave out.

``test_interleave.py`` holds the check to the interleave's rules.
"""

from __future__ import annotations

import pytest
import torch

from bench_torch import check, run, serve, spec

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _cell(bench, name):
    cell = spec.workload(bench, name)
    return cell, *run.tiny(bench, cell)


@pytest.mark.parametrize("name", ["uhd60.settled", "uhd60.drag", "screen1440.settled",
                                  "uhd60.interleave1"])
def test_control_is_not_correct(bench, name):
    cell, cfg, traffic = _cell(bench, name)
    c = serve.Cell(cfg, traffic, 5, "cpu", docks=False)
    want, ctrl, same = (check.Expect(c, "cpu", dt) for dt in
                        (torch.float32, torch.bfloat16, torch.float32))
    tms = check.clock(40)
    pools = [j % 3 for j in range(40)]
    off = dict.fromkeys(("panel_bytes_off", "capture_bytes_off", "counts_off"), 0)
    for j in range(traffic["warmup_frames"], traffic["warmup_frames"] + 4):
        args = (0, pools, j, tms[j])
        for got, into in ((ctrl, off), (same, None)):
            panel, f = got.of(*args)
            nums = check.compare(want.of(*args), panel.numpy(),
                                 (f.capture.permute(2, 0, 1), f.vs, f.wv, f.hi), "cpu")
            if into is None:
                assert not any(nums.values()), nums
            else:
                for k, v in nums.items():
                    into[k] += v
    assert any(v > 0 for v in off.values()), off


def _measure(bench, name):
    cell, cfg, traffic = _cell(bench, name)
    return run.measure(bench, cell, 3, 3.0, False, "cpu", cfg, traffic)


SETTLED = ["uhd60.settled", "screen1440.settled", "uhd60.interleave1"]


@pytest.mark.parametrize("name", SETTLED)
def test_sound_run_is_correct(bench, name):
    res = _measure(bench, name)
    assert res["correct"], res["checks"]


def _patch_analyze(monkeypatch, fn):
    """``fn(analyze)`` in place of the analysis of both routes: the settled
    route's (``models.dock``) and the dynamic dock step's (``dock_step``)."""
    from obs_color_monitor_tpu_torch import dock_step
    from obs_color_monitor_tpu_torch.models import dock

    for mod in (dock, dock_step):
        monkeypatch.setattr(mod, "analyze", fn(mod.analyze))


@pytest.mark.parametrize("name", SETTLED)
def test_stale_state_is_not_correct(bench, monkeypatch, name):
    from obs_color_monitor_tpu_torch import graphs

    call = graphs.CapturedStep.__call__
    first = {}

    def stale(self, *args):
        out = call(self, *args)
        return first.setdefault(id(self), out)

    monkeypatch.setattr(graphs.CapturedStep, "__call__", stale)
    assert not _measure(bench, name)["correct"]


@pytest.mark.parametrize("name", SETTLED)
def test_half_frame_left_out_is_not_correct(bench, monkeypatch, name):
    def half(analyze):
        def f(x, *a, **k):
            return analyze(x[: x.shape[0] // 2], *a, **k)
        return f

    _patch_analyze(monkeypatch, half)
    assert not _measure(bench, name)["correct"]


def test_altered_count_is_not_correct(bench, monkeypatch):
    def altered(analyze):
        def f(*a, **k):
            res = analyze(*a, **k)
            vs = res.vs_counts.clone()
            vs[128, 128] ^= 1  # one count off by one
            return res._replace(vs_counts=vs)
        return f

    _patch_analyze(monkeypatch, altered)
    res = _measure(bench, "uhd60.drag")
    assert not res["correct"] and res["checks"]["counts_off"]["value"] > 0
