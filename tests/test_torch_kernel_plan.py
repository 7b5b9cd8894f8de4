"""The launch geometry of kernels K1 and K2, computed in Python, and the
wrappers' argument checks: pure functions, held here on the CPU.

``scope_stats.stats_plan`` sizes K2's vectorscope runs and waveform strips,
``pipeline.frame_plan`` K1's tiles and scale grid.  At every shape the
reference's tests use and at 4K they must count every pixel exactly once,
keep every 16-bit counter field at or under 65535, and depend on the shape
(and the planes' alignment), never on a rect.
"""

import inspect

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu_torch.ops import pipeline as tp
from obs_color_monitor_tpu_torch.ops import scope_stats as ss

# the reference's shapes (full-res), the (17, 33) tile, 1080p and 4K
FRAMES = [(13, 17), (65, 144), (129, 131), (131, 133), (131, 270), (140, 270), (17, 33),
          (1080, 1920), (2160, 3840)]
SCALES = (1, 2, 3, 4, 8)
# the planes K2 counts: every scaled frame above, crops, and frames with
# fewer rows than a waveform cluster has blocks
PLANES = sorted({(h // s, w // s) for h, w in FRAMES for s in SCALES if h >= s and w >= s}
                | {(810, 1440), (1080, 1441), (1, 1), (3, 2000), (5, 40), (7, 16), (0, 5)})


def _vs_runs(plan, n):
    """Each vectorscope block's pixel run [b0, b1)."""
    blocks = plan.vs_clusters * ss.VS_CLUSTER
    return [(b * plan.vs_per_block, min((b + 1) * plan.vs_per_block, n)) for b in range(blocks)]


def _wv_runs(plan, h):
    """Each waveform block's (strip, rows [y0, y1))."""
    return [(s, r * plan.wv_rows, min((r + 1) * plan.wv_rows, h))
            for s in range(plan.wv_strips) for r in range(plan.wv_cluster)]


# the counts asked for (need_vs, need_wv): both, the vectorscope alone,
# the waveform alone; each picks its own grids
FLAGS = [(True, True), (True, False), (False, True)]


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("h,w", PLANES)
def test_stats_plan_counts_every_pixel_once(h, w, flags):
    plan = ss.stats_plan(h, w, need_vs=flags[0], need_wv=flags[1])
    n = h * w
    cover = np.zeros(n + 1, np.int64)
    for b0, b1 in _vs_runs(plan, n):
        if b1 > b0:
            cover[b0] += 1
            cover[b1] -= 1
    assert np.all(np.cumsum(cover)[:n] == 1)
    cells = np.zeros((max(h, 1), plan.wv_strips * ss.WV_STRIP), np.int64)
    for s, y0, y1 in _wv_runs(plan, h):
        cells[y0:y1, s * ss.WV_STRIP:(s + 1) * ss.WV_STRIP] += 1
    assert np.all(cells[:h, :w] == 1)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("h,w", PLANES)
def test_stats_plan_no_field_overflows(h, w, flags):
    plan = ss.stats_plan(h, w, need_vs=flags[0], need_wv=flags[1])
    # a vectorscope field counts at most the block's run; a waveform field
    # (one column, one bin) at most the block's rows
    assert max(b1 - b0 for b0, b1 in _vs_runs(plan, h * w)) <= ss.FIELD_MAX
    assert plan.vs_per_block <= ss.FIELD_MAX and plan.vs_per_block % 16 == 0
    assert plan.wv_rows <= ss.FIELD_MAX
    # the waveform's cluster is one of the two sizes the kernel is built for
    assert plan.wv_cluster == (ss.WV_CLUSTER_BESIDE_VS if all(flags) else ss.WV_CLUSTER_ALONE)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("h,w", [(1080, 1920), (2160, 3840), (810, 1440)])
def test_stats_plan_main_path_shapes(h, w, flags):
    plan = ss.stats_plan(h, w, need_vs=flags[0], need_wv=flags[1])
    # the vectorscope grid fits the card in one wave, the cp.async forms apply
    assert plan.vs_clusters * ss.VS_CLUSTER <= 128
    assert plan.vs_vec and plan.wv_vec


def test_stats_plan_forms_follow_alignment():
    assert not ss.stats_plan(64, 96, vs_aligned=False).vs_vec
    assert not ss.stats_plan(64, 96, wv_aligned=False).wv_vec
    assert not ss.stats_plan(1080, 1441).wv_vec  # rows not 16-byte aligned
    assert ss.stats_plan(1080, 1441).vs_vec  # the vectorscope reads flat runs


def test_plans_take_no_rect():
    """The grids are a function of the shape (and alignment) alone."""
    for fn in (ss.stats_plan, tp.frame_plan):
        assert not any("rect" in p for p in inspect.signature(fn).parameters)
    assert ss.stats_plan(1080, 1920).as_tuple() == ss.stats_plan(1080, 1920).as_tuple()
    # beside the waveform the vectorscope takes fewer blocks, leaving it SMs
    both, alone = ss.stats_plan(1080, 1920), ss.stats_plan(1080, 1920, need_wv=False)
    assert both.vs_clusters < alone.vs_clusters


def test_stats_plan_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ss.stats_plan(-1, 4)
    with pytest.raises(ValueError):
        ss.stats_plan(ss.WV_CLUSTER_ALONE * ss.FIELD_MAX + 1, 4)
    with pytest.raises(ValueError):  # beside the vectorscope a strip has fewer blocks
        ss.stats_plan(ss.WV_CLUSTER_BESIDE_VS * ss.FIELD_MAX + 1, 4)
    assert ss.stats_plan(ss.WV_CLUSTER_ALONE * ss.FIELD_MAX, 4, need_vs=False).wv_rows == ss.FIELD_MAX


def _tile_cover(plan, h4, w4):
    """How many times the tile launch's threads write each full-res pixel."""
    cover = np.zeros((plan.tiles[1] * tp.TILE_H, plan.tiles[0] * tp.TILE_W), np.int64)
    runs = tp.TILE_W // tp.RUN
    for ty in range(plan.tiles[1]):
        for tx in range(plan.tiles[0]):
            for t in range(runs * tp.TILE_ROW_GROUPS):
                cx, ry = (t % runs) * tp.RUN, t // runs
                for r in range(ry, tp.TILE_H, tp.TILE_ROW_GROUPS):
                    cover[ty * tp.TILE_H + r, tx * tp.TILE_W + cx:tx * tp.TILE_W + cx + tp.RUN] += 1
    return cover[:h4, :w4]


def _scaled_cover(plan, h, w):
    """How many times the launches write each scaled pixel."""
    if plan.fused:  # each tile: the TILE_H/2 x TILE_W/2 scaled pixels under it
        gx, gy, bw, bh = *plan.tiles, tp.TILE_W // 2, tp.TILE_H // 2
    else:
        gx, gy, bw, bh = *plan.scale_grid, tp.SCALE_BLOCK_W, tp.SCALE_BLOCK_H
    cover = np.zeros((gy * bh, gx * bw), np.int64)
    for by in range(gy):
        for bx in range(gx):
            cover[by * bh:(by + 1) * bh, bx * bw:(bx + 1) * bw] += 1
    return cover[:h, :w]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("h4,w4", FRAMES[:-2] + [(1080, 1920)])
def test_frame_plan_covers_every_pixel_once(h4, w4, packed):
    for scale in SCALES:
        if h4 < scale or w4 < scale:
            continue
        h, w = h4 // scale, w4 // scale
        for with_overlays in (False, True):
            plan = tp.frame_plan(h4, w4, scale, packed, with_overlays)
            assert plan.fused == (with_overlays and scale == 2)
            if with_overlays:
                assert np.all(_tile_cover(plan, h4, w4) == 1)
                # the fused scale-2 sample's texels (2ox..2ox+1, 2oy..2oy+1)
                # lie in the tile that owns the output pixel
                assert tp.TILE_W % 2 == 0 and tp.TILE_H % 2 == 0
            else:
                assert plan.tiles == (0, 0)
            assert np.all(_scaled_cover(plan, h, w) == 1)


def test_frame_plan_4k_main_path():
    plan = tp.frame_plan(2160, 3840, 2, True, True)
    assert plan.vec and plan.fused and plan.scale_grid == (0, 0)
    assert plan.tiles == (3840 // tp.TILE_W, 2160 // tp.TILE_H)
    scale_only = tp.frame_plan(2160, 3840, 2, False, False)
    assert scale_only.vec and not scale_only.fused and scale_only.tiles == (0, 0)


@pytest.mark.parametrize("w4,packed,aligned,vec", [
    (3840, True, True, True), (17, True, True, False), (132, True, True, True),
    (3840, False, True, True), (3848, False, True, False), (3840, True, False, False),
])
def test_frame_plan_wide_load_form(w4, packed, aligned, vec):
    assert tp.frame_plan(32, w4, 2, packed, True, aligned).vec == vec


def test_frame_plan_rejects_bad_scales():
    with pytest.raises(ValueError):
        tp.frame_plan(16, 16, 0, True, True)
    with pytest.raises(ValueError):
        tp.frame_plan(4, 16, 8, True, False)


def _planes(h=6, w=10):
    rng = np.random.default_rng(0)
    yuv = torch.from_numpy(rng.integers(0, 256, (3, h, w), np.uint8))
    return yuv[1], yuv[2], yuv, (yuv[0] > 10)


@pytest.mark.parametrize("case", ["u_shape", "u_dtype", "u_strided", "data_shape", "data_rows",
                                  "mask_shape", "rect_dtype", "rect_shape"])
def test_stats_argument_checks(case):
    u, v, data, mask = _planes()
    rect = torch.tensor((1, 1, 5, 5), dtype=torch.int32)
    if case == "u_shape":
        u = u[:5]
    elif case == "u_dtype":
        u = u.to(torch.int16)
    elif case == "u_strided":
        u = torch.zeros((6, 20), dtype=torch.uint8)[:, ::2]
    elif case == "data_shape":
        data = data[:2]
    elif case == "data_rows":
        data = torch.zeros((3, 6, 20), dtype=torch.uint8)[:, :, ::2]
    elif case == "mask_shape":
        mask = mask[:, :4]
    elif case == "rect_dtype":
        rect = rect.to(torch.int64)
    elif case == "rect_shape":
        rect = rect[:3]
    with pytest.raises(ValueError):
        ss.check_stats_inputs(u, v, data, mask, need_vs=True, need_wv=True, rect=rect)


def test_stats_argument_checks_pass_and_skip_unused_inputs():
    u, v, data, mask = _planes()
    assert ss.check_stats_inputs(u, v, data, mask, need_vs=True, need_wv=True, rect=None) == (6, 10)
    # the skipped count's inputs are not read, so not checked
    assert ss.check_stats_inputs(u, v, None, None, need_vs=True, need_wv=False, rect=None) == (6, 10)
    assert ss.check_stats_inputs(None, None, data, None, need_vs=False, need_wv=True,
                                 rect=None) == (6, 10)


def test_stats_wrapper_refuses_other_devices_and_no_count():
    u, v, data, mask = (t.to("meta") for t in _planes())
    with pytest.raises(ValueError):
        ss.vs_wv_counts(u, v, data, mask)
    with pytest.raises(ValueError):
        ss.vs_wv_counts(*_planes(), need_vs=False, need_wv=False)


@pytest.mark.parametrize("case", ["packed_ndim", "planar_channels", "planar_dtype", "scale",
                                  "too_small", "strided"])
def test_frame_argument_checks(case):
    packed, scale = True, 2
    frame = torch.zeros((16, 24), dtype=torch.int32)
    if case == "packed_ndim":
        frame = torch.zeros((16, 24, 1), dtype=torch.int32)
    elif case == "planar_channels":
        packed, frame = False, torch.zeros((3, 16, 24), dtype=torch.uint8)
    elif case == "planar_dtype":
        packed, frame = False, torch.zeros((4, 16, 24), dtype=torch.int16)
    elif case == "scale":
        scale = 0
    elif case == "too_small":
        scale = 32
    elif case == "strided":
        frame = torch.zeros((16, 48), dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError):
        tp.check_frame_inputs(frame, packed, scale)


def test_frame_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        tp.frame_pass(torch.zeros((16, 24), dtype=torch.int32, device="meta"), packed=True, cs=2,
                      scale=2)
    assert tp.check_frame_inputs(torch.zeros((16, 24), dtype=torch.int32), True, 2) == (16, 24, 8, 12)
