"""The launch geometry of kernels K1, K2 and K3, computed in Python, and
the wrappers' argument checks: pure functions, held here on the CPU.

``scope_stats.stats_plan`` sizes K2's vectorscope runs and waveform strips,
``pipeline.frame_plan`` K1's tiles and scale grid, ``fused_overlays.
overlay_plan`` K3's tiles.  At every shape the
reference's tests use and at 4K they must count every pixel exactly once,
keep every 16-bit counter field at or under 65535, and depend on the shape
(and the planes' alignment), never on a rect.
"""

import inspect

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu_torch.ops import fused_overlays as fo
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


# K3: overlay_plan over the reference's shapes (and the (33, 17) tile),
# the dock's 1080p capture and 4K
OVERLAY_FRAMES = [(13, 17), (33, 17), (65, 144), (129, 131), (131, 133), (131, 270),
                  (1080, 1920), (2160, 3840)]


def _overlay_tile_pattern():
    """How many times one K3 block's threads write each pixel of its tile:
    thread t takes the run at column (t % runs) * RUN of rows t // runs,
    t // runs + ROW_GROUPS, ... (fused_overlays.cu's loop)."""
    runs = fo.TILE_W // fo.RUN
    cover = np.zeros((fo.TILE_H, fo.TILE_W), np.int64)
    for t in range(fo.THREADS):
        cx = (t % runs) * fo.RUN
        for ry in range(t // runs, fo.TILE_H, fo.ROW_GROUPS):
            cover[ry, cx:cx + fo.RUN] += 1
    return cover


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("h,w", OVERLAY_FRAMES)
def test_overlay_plan_covers_every_pixel_once(h, w, packed_out):
    plan = fo.overlay_plan(h, w, packed_out)
    tx, ty = plan.tiles
    assert (tx - 1) * fo.TILE_W < w <= tx * fo.TILE_W
    assert (ty - 1) * fo.TILE_H < h <= ty * fo.TILE_H
    cover = np.tile(_overlay_tile_pattern(), (ty, tx))
    assert np.all(cover[:h, :w] == 1)


def test_overlay_plan_one_wave_at_the_dock_capture():
    """The 1080p capture fits one wave of 4 blocks on each of 132 SMs,
    where K1's 16 x 256 tile would need a second."""
    plan = fo.overlay_plan(1080, 1920, True)
    assert plan.tiles == (15, 34) and plan.tiles[0] * plan.tiles[1] <= 4 * 132
    assert -(-1920 // 256) * -(-1080 // 16) > 4 * 132
    assert plan.vec and plan.store_bytes == 16
    assert fo.overlay_plan(2160, 3840, True) == fo.OverlayPlan(True, 16, (30, 68))


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("w", [17, 131, 132, 144, 270, 1441, 1920])
def test_overlay_plan_wide_forms_follow_alignment(w, aligned, packed_out):
    plan = fo.overlay_plan(40, w, packed_out, aligned)
    # 16-byte copies: a 16-byte aligned base and rows (w % 16 == 0)
    assert plan.vec == (aligned and w % 16 == 0)
    # a run's stores are whole words when w % 4 == 0: 16 bytes packed
    # (4 pixels), one word per plane; else a pixel or a byte at a time
    if packed_out:
        assert plan.store_bytes == (16 if w % 4 == 0 else 4)
    else:
        assert plan.store_bytes == (4 if w % 4 == 0 else 1)


def test_overlay_plan_fields_and_launch_args():
    """The plan's grid fits its C int fields, and the cached kernel
    arguments carry the plan's forms."""
    assert fo.overlay_plan(0, 5, True).tiles == (0, 0)
    assert fo.overlay_plan(65535 * fo.TILE_H, 4, False).tiles == (1, 65535)
    with pytest.raises(ValueError):
        fo.overlay_plan(65535 * fo.TILE_H + 1, 4, False)
    with pytest.raises(ValueError):
        fo.overlay_plan(-1, 4, True)
    for w, packed_out, aligned in ((1920, True, True), (270, False, True), (1920, True, False)):
        op, lp, *_, plan = fo._launch_args(1080, w, 0.75, 1.0, 2, 1, 3062, (255, 84, 0, 255),
                                           packed_out, aligned)
        assert (lp.vec, lp.packed_out, lp.word) == (plan.vec, packed_out, w % 4 == 0)
        assert (lp.tiles_x, lp.tiles_y) == plan.tiles
        assert (op.h, op.w, op.kl_fc[0]) == (1080, w, 1225)
    # one set of static arguments builds its structures once
    a = fo._launch_args(64, 64, 0.75, 1.0, 2, 2, 0, (0, 0, 0, 0), True, True)
    assert fo._launch_args(64, 64, 0.75, 1.0, 2, 2, 0, (0, 0, 0, 0), True, True) is a


def test_overlay_plan_takes_no_rect():
    assert not any("rect" in p for p in inspect.signature(fo.overlay_plan).parameters)


@pytest.mark.parametrize("case", ["channels", "dtype", "strided", "no_output", "rect_dtype",
                                  "rect_shape", "rect_strided", "rect_device"])
def test_overlay_argument_checks(case):
    planes = torch.zeros((4, 6, 10), dtype=torch.uint8)
    rect, outputs = torch.tensor((1, 1, 5, 5), dtype=torch.int32), fo.ALL
    if case == "channels":
        planes = planes[:3]
    elif case == "dtype":
        planes = planes.to(torch.int16)
    elif case == "strided":
        planes = torch.zeros((4, 6, 20), dtype=torch.uint8)[:, :, ::2]
    elif case == "no_output":
        outputs = (False, False, False)
    elif case == "rect_dtype":
        rect = rect.to(torch.int64)
    elif case == "rect_shape":
        rect = rect[:3]
    elif case == "rect_strided":
        rect = torch.zeros(8, dtype=torch.int32)[::2]
    elif case == "rect_device":
        rect = rect.to("meta")
    with pytest.raises(ValueError):
        fo.check_overlay_inputs(planes, rect, outputs)


def test_overlay_argument_checks_pass():
    planes = torch.zeros((4, 6, 10), dtype=torch.uint8)
    assert fo.check_overlay_inputs(planes, None, (False, False, True)) == (6, 10)
    assert fo.check_overlay_inputs(planes, (1, 2, 3, 4), fo.ALL) == (6, 10)
    rect = torch.tensor((1, 1, 5, 5), dtype=torch.int32)
    assert fo.check_overlay_inputs(planes, rect, fo.ALL) == (6, 10)


def test_fc_bucket_table_gives_every_band():
    """K3's false-colour band from its table (one lookup by luma >> 12 and
    one compare) equals the count of bounds <= luma at every luma of u8 RGB
    in both colorspaces, and K3's luma coefficients split into bytes."""
    from obs_color_monitor_tpu_torch.ops import overlays as ov

    table = fo.fc_bucket_table().astype(np.int64)
    assert table.shape == (fo.FC_BUCKETS,)
    top = max(255 * sum(fo.check_luma_coefficients(cs)) for cs in (1, 2))
    luma = np.arange(top + 1)
    entry = table[luma >> 12]
    band = (entry >> 20) + (luma >= (entry & 0xFFFFF))
    assert np.array_equal(band, np.searchsorted(np.asarray(ov.BAND_THRESH), luma, side="right"))
    for cs in (1, 2):
        assert all(0 <= k < 1 << 16 for k in fo.check_luma_coefficients(cs))


@pytest.mark.parametrize("thresh", [(10, 4000, 9000), (5000, 4000), (0, 1 << 20)])
def test_fc_bucket_table_rejects_what_the_kernel_cannot_take(thresh):
    """Two bounds in one bucket of 4096, bounds out of order or past the
    table's range."""
    with pytest.raises(ValueError):
        fo.fc_bucket_table(thresh)
