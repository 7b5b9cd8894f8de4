"""The hand-written kernels against their plain versions on a CUDA card.

Marked ``cuda``; each test skips when no card is present (decided inside a
fixture, never at import).  Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu_torch import DockConfig, frame_from_numpy, make_dock_step, make_full_step
from obs_color_monitor_tpu_torch import config as cfg
from obs_color_monitor_tpu_torch.ops import convert as cv
from obs_color_monitor_tpu_torch.ops import decode as dec
from obs_color_monitor_tpu_torch.ops import fused_overlays as fo
from obs_color_monitor_tpu_torch.ops import pipeline as tp
from obs_color_monitor_tpu_torch.ops import scope_stats as ss

pytestmark = pytest.mark.cuda

ARGS = dict(th_low=0.75, th_high=1.0, zb_cs=2, fc_cs=1, peak_th=3062,
            peak_rgba=(255, 84, 0, 255))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frame(h, w, seed, flat=False):
    rng = np.random.default_rng(seed)
    f = np.full((h, w, 4), 128, np.uint8) if flat else rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
    return f


@pytest.mark.parametrize(
    "h,w,scale,yuv_data,packed,flat",
    [
        (13, 17, 2, False, True, False),
        (17, 33, 1, True, False, False),
        (65, 144, 3, False, False, True),
        (129, 131, 2, True, True, False),
        (131, 270, 4, False, True, True),
        (140, 270, 8, True, False, False),
    ],
)
def test_kernels_equal_plain_versions(cuda, h, w, scale, yuv_data, packed, flat):
    f = _frame(h, w, h * w, flat)
    arr = f.view(np.int32)[..., 0] if packed else np.ascontiguousarray(np.moveaxis(f, -1, 0))
    x = torch.from_numpy(np.ascontiguousarray(arr)).to(cuda)
    kw = dict(packed=packed, cs=2, scale=scale, **ARGS)
    got = tp.frame_pass(x, 2.5, **kw)
    ref = tp.frame_pass_reference(x, 2.5, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    inputs = tp.stats_inputs(*ref[:2], yuv_data)
    for a, b in zip(ss.vs_wv_counts(*inputs), ss.vs_wv_counts_reference(*inputs)):
        assert torch.equal(a, b)
    # and the CPU route gives the same
    cpu = tp.frame_pipeline(x.cpu(), 2.5, yuv_data=yuv_data, **kw)
    dev = tp.frame_pipeline(x, 2.5, yuv_data=yuv_data, **kw)
    for a, b in zip(dev, cpu):
        assert torch.equal(a.cpu(), b)


def test_full_step_cuda_equals_cpu(cuda):
    f = _frame(135, 240, 5)
    outs = []
    for dev in ("cuda", "cpu"):  # "cuda" without an index takes any card's frames
        step = make_full_step(135, 240, scale=2, input_format="rgba", device=dev)
        launches = tp.frame_pass.launches
        outs.append(step(frame_from_numpy(f, "rgba", cuda if dev == "cuda" else dev),
                         1.5).to_numpy())
        if dev != "cpu":
            assert tp.frame_pass.launches == launches + 1
    for k, v in outs[1].items():
        assert np.array_equal(outs[0][k], v), k


@pytest.mark.parametrize("h,w", [(2, 8), (66, 142), (130, 256)])
@pytest.mark.parametrize("cs", [1, 2])
def test_nv12_decode_kernel(cuda, h, w, cs):
    rng = np.random.default_rng(h + w + cs)
    y = torch.from_numpy(rng.integers(0, 256, (h, w), np.uint8)).to(cuda)
    uv = torch.from_numpy(rng.integers(0, 256, (h // 2, w), np.uint8)).to(cuda)
    launches = dec.nv12_decode.launches
    got = dec.nv12_decode(y, uv, cs=cs)
    assert dec.nv12_decode.launches == launches + 1
    assert torch.equal(got, cv.nv12_packed_reference(y, uv, cs))


@pytest.mark.parametrize("shift", [0, 8])
def test_nv12_to_packed_is_uint32_on_the_card(cuda, shift):
    """The public route returns the uint32 view, as JAX's does, from one
    K4 (K5) launch; ``as_packed`` takes it back to the kernel's int32."""
    import chip_smoke

    y, uv = (torch.from_numpy(p).to(cuda)
             for p in chip_smoke.make_nv12(66, 142, 9, bits=10 if shift else 8, msb=True))
    wrapper = dec.nv12_16_decode if shift else dec.nv12_decode
    launches = wrapper.launches
    got = cv.nv12_to_packed(y, uv, cs=2, shift=shift)
    assert got.dtype == torch.uint32 and wrapper.launches == launches + 1
    want = (cv.nv12_16_packed_reference(y, uv, 2, shift) if shift
            else cv.nv12_packed_reference(y, uv, 2))
    assert torch.equal(cv.as_packed(got), want)


@pytest.mark.parametrize("bits,msb", [(10, False), (10, True), (12, False), (16, False)])
def test_nv12_16_decode_kernel(cuda, bits, msb):
    rng = np.random.default_rng(bits)
    h, w = 130, 254
    a = rng.integers(0, 1 << bits, (h * 3 // 2, w)).astype(np.uint16)
    if msb:
        a = (a << (16 - bits)).astype(np.uint16)
    a[0, :3] = (0, 65535, 1 << (bits - 1))
    y, uv = (torch.from_numpy(np.ascontiguousarray(p)).to(cuda) for p in (a[:h], a[h:]))
    shift = cv.nv12_shift(bits, msb)
    got = dec.nv12_16_decode(y, uv, cs=2, shift=shift)
    assert torch.equal(got, cv.nv12_16_packed_reference(y, uv, 2, shift))


@pytest.mark.parametrize("packed_out", [False, True])
@pytest.mark.parametrize(
    "h,w,rect,outputs",
    [
        (13, 17, None, (True, True, True)),
        (65, 144, (5, 3, 100, 60), (True, True, True)),
        (131, 270, (0, 0, 270, 40), (True, False, True)),
        (33, 17, (16, 32, 17, 33), (False, False, True)),
    ],
)
def test_fused_overlays_kernel(cuda, h, w, rect, outputs, packed_out):
    p = np.ascontiguousarray(np.moveaxis(_frame(h, w, h + w), -1, 0))
    x = torch.from_numpy(p).to(cuda)
    kw = dict(ARGS, rect=rect, packed_out=packed_out, outputs=outputs)
    launches = fo.fused_overlays_planes.launches
    got = fo.fused_overlays_planes(x, 7.3, **kw)
    assert fo.fused_overlays_planes.launches == launches + 1
    for a, b in zip(got, fo.fused_overlays_reference(x, 7.3, **kw)):
        assert (a is None and b is None) or torch.equal(a, b)


def test_scope_stats_single_kernels(cuda):
    f = _frame(131, 270, 3)
    ds, yuv, *_ = tp.frame_pass_reference(torch.from_numpy(f.view(np.int32)[..., 0]).to(cuda),
                                          packed=True, cs=2, scale=2, with_overlays=False)
    ds, yuv = ds[:, 5:50, 7:101].contiguous(), yuv[:, 5:50, 7:101].contiguous()
    for fam in (False, True):
        inputs = tp.stats_inputs(ds, yuv, fam)
        for need_vs, need_wv in ((True, False), (False, True)):
            got = ss.vs_wv_counts(*inputs, need_vs=need_vs, need_wv=need_wv)
            ref = ss.vs_wv_counts_reference(*inputs, need_vs=need_vs, need_wv=need_wv)
            for a, b in zip(got, ref):
                assert (a is None and b is None) or torch.equal(a, b)


def test_dock_step_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(9)
    y = rng.integers(0, 256, (136, 240), np.uint8)
    uv = rng.integers(0, 256, (68, 240), np.uint8)
    outs = []
    for dev in (cuda, "cpu"):
        step = make_dock_step(136, 240, input_format="nv12", out_height=900,
                              dock=DockConfig(show_focuspeaking=True), device=dev)
        outs.append(step(frame_from_numpy((y, uv), "nv12", dev), 1.5).to_numpy())
    for k, v in outs[1].items():
        assert np.array_equal(outs[0][k], v), k


RECTS = [(10, 8, 50, 40), (0, 0, 120, 68), (-7, -3, 30, 20), (40, 30, 500, 300),
         (30, 30, 30, 40), (50, 10, -3, 50), (119, 67, 120, 68)]


def test_scope_stats_rect_modes(cuda):
    f = _frame(136, 240, 4)
    ds, yuv, *_ = tp.frame_pass_reference(torch.from_numpy(f.view(np.int32)[..., 0]).to(cuda),
                                          packed=True, cs=2, scale=2, with_overlays=False)
    launches = ss.vs_wv_counts.launches_rect
    for r in RECTS:
        rect = torch.tensor(r, dtype=torch.int32, device=cuda)
        for fam in (False, True):
            inputs = tp.stats_inputs(ds, yuv, fam)
            for need_vs, need_wv in ((True, True), (True, False), (False, True)):
                kw = dict(need_vs=need_vs, need_wv=need_wv, rect=rect)
                got = ss.vs_wv_counts(*inputs, **kw)
                for a, b in zip(got, ss.vs_wv_counts_reference(*inputs, **kw)):
                    assert (a is None and b is None) or torch.equal(a, b), (r, fam)
    assert ss.vs_wv_counts.launches_rect == launches + len(RECTS) * 6


@pytest.mark.parametrize("packed_out", [False, True])
def test_fused_overlays_rect_tensor(cuda, packed_out):
    p = np.ascontiguousarray(np.moveaxis(_frame(68, 120, 6), -1, 0))
    x = torch.from_numpy(p).to(cuda)
    for r in RECTS:
        kw = dict(ARGS, rect=torch.tensor(r, dtype=torch.int32, device=cuda),
                  packed_out=packed_out)
        for a, b in zip(fo.fused_overlays_planes(x, 5.3, **kw),
                        fo.fused_overlays_reference(x, 5.3, **kw)):
            assert torch.equal(a, b), r


@pytest.mark.parametrize("h,w,scale", [(13, 17, 2), (131, 270, 2), (67, 190, 1), (128, 256, 2)])
@pytest.mark.parametrize("yuv_data", [False, True])
def test_fused_ingest_stats(cuda, h, w, scale, yuv_data):
    p = np.ascontiguousarray(np.moveaxis(_frame(h, w, h + w), -1, 0))
    x = torch.from_numpy(p).to(cuda)
    launches = (tp.frame_pass.launches, ss.vs_wv_counts.launches)
    got = tp.fused_ingest_stats(x, 2, scale, yuv_data)
    assert (tp.frame_pass.launches, ss.vs_wv_counts.launches) == (launches[0] + 1,
                                                                   launches[1] + 1)
    for a, b in zip(got, tp.fused_ingest_stats_reference(x.cpu(), 2, scale, yuv_data)):
        assert torch.equal(a.cpu(), b)


def test_dynamic_dock_step_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(10)
    y = rng.integers(0, 256, (136, 240), np.uint8)
    uv = rng.integers(0, 256, (68, 240), np.uint8)
    steps = {dev: make_dock_step(136, 240, input_format="nv12", out_height=900,
                                 dock=DockConfig(show_focuspeaking=True), dynamic_roi=True,
                                 device=dev) for dev in (cuda, "cpu")}
    counts = []
    for r in RECTS:
        outs = []
        for dev, step in steps.items():
            before = (tp.frame_pass.launches, ss.vs_wv_counts.launches,
                      fo.fused_overlays_planes.launches, dec.nv12_decode.launches)
            rect = torch.tensor(r, dtype=torch.int32, device=dev)
            outs.append(step(frame_from_numpy((y, uv), "nv12", dev), 1.5, rect).to_numpy())
            if dev != "cpu":
                counts.append(tuple(a - b for a, b in zip(
                    (tp.frame_pass.launches, ss.vs_wv_counts.launches,
                     fo.fused_overlays_planes.launches, dec.nv12_decode.launches), before)))
        for k, v in outs[1].items():
            assert np.array_equal(outs[0][k], v), (r, k)
    assert len(set(counts)) == 1 and min(counts[0]) >= 1


def test_dock_cuda_equals_cpu(cuda):
    from obs_color_monitor_tpu_torch.models import Dock

    rng = np.random.default_rng(12)
    docks = [Dock(DockConfig(show_focuspeaking=True), device=dev) for dev in (cuda, "cpu")]
    for i in range(6):
        y = rng.integers(0, 256, (96, 160), np.uint8)
        uv = rng.integers(0, 256, (48, 160), np.uint8)
        if i == 3:
            for d in docks:
                d.hub.set_roi(5, 4, 60, 40)
        panels = []
        for d in docks:
            d.push_nv12(y, uv)
            panels.append(d.render(width=256, height=900))
        assert np.array_equal(*panels), i
        assert np.array_equal(docks[0].histogram.counts(), docks[1].histogram.counts()), i
        assert np.array_equal(docks[0].vectorscope._read().cpu().numpy(),
                              docks[1].vectorscope._read().numpy()), i


def test_dynamic_dock_step_cuda_graph_replay(cuda):
    """One dynamic-ROI step captured in a CUDA graph replays for any rect
    written into its rect tensor, equal to the eager step: the step reads
    the rect on the card only and allocates nothing by it."""
    rng = np.random.default_rng(13)
    y = torch.from_numpy(rng.integers(0, 256, (136, 240), np.uint8)).to(cuda)
    uv = torch.from_numpy(rng.integers(0, 256, (68, 240), np.uint8)).to(cuda)
    step = make_dock_step(136, 240, input_format="nv12", out_height=900, dynamic_roi=True,
                          dock=DockConfig(show_focuspeaking=True), device=cuda)
    rect = torch.tensor(RECTS[0], dtype=torch.int32, device=cuda)
    # the uncaptured step, captured here by hand (the builder's own capture
    # is tested in test_captured_steps_equal_eager)
    eager_step = step.eager
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        for _ in range(2):
            eager_step((y, uv), 2.0, rect)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = eager_step((y, uv), 2.0, rect)
    for r in RECTS[1:]:
        rect.copy_(torch.tensor(r, dtype=torch.int32))
        graph.replay()
        eager = eager_step((y, uv), 2.0,
                           torch.tensor(r, dtype=torch.int32, device=cuda)).to_numpy()
        for k, v in out.to_numpy().items():
            assert np.array_equal(v, eager[k]), (r, k)


SHAPES = [(13, 17), (65, 144), (129, 131), (131, 133), (131, 270), (140, 270), (17, 33)]


def _kind_frame(h, w, kind, seed):
    import chip_smoke

    return chip_smoke.make_frame(h, w, kind, seed)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("h,w", SHAPES)
def test_k1_k2_bit_exact_over_shapes(cuda, h, w, packed):
    """K1 at every scale the shape allows and K2 on its outputs, both
    families, random / flat / bar frames: equal to the plain versions."""
    n = 0
    for scale in (1, 2, 3, 4, 8):
        if h < scale or w < scale:
            continue
        for kind in ("random", "flat", "bars"):
            n += 1
            f = _kind_frame(h, w, kind, h * w + n)
            arr = f.view(np.int32)[..., 0] if packed else np.moveaxis(f, -1, 0)
            x = torch.from_numpy(np.ascontiguousarray(arr)).to(cuda)
            for with_overlays in (True, False):
                kw = dict(packed=packed, cs=1 + n % 2, scale=scale, with_overlays=with_overlays,
                          **ARGS)
                got = tp.frame_pass(x, 0.3 * n, **kw)
                ref = tp.frame_pass_reference(x, 0.3 * n, **kw)
                for a, b in zip(got, ref):
                    assert (a is None and b is None) or torch.equal(a, b), (scale, kind)
            for fam in (False, True):
                inputs = tp.stats_inputs(*ref[:2], fam)
                for a, b in zip(ss.vs_wv_counts(*inputs), ss.vs_wv_counts_reference(*inputs)):
                    assert torch.equal(a, b), (scale, kind, fam)


@pytest.mark.parametrize("h,w", [(1, 1), (5, 40), (3, 2000), (7, 16), (1080, 1441)])
def test_k2_small_and_unaligned_planes(cuda, h, w):
    """Fewer rows than a waveform cluster has blocks, and planes whose starts
    or rows are not 16-byte aligned: the kernel's plain-load form."""
    f = _kind_frame(h, w, "random", h + w)
    ds, yuv, *_ = tp.frame_pass_reference(torch.from_numpy(f.view(np.int32)[..., 0]).to(cuda),
                                          packed=True, cs=2, scale=1, with_overlays=False)
    for fam in (False, True):
        inputs = tp.stats_inputs(ds, yuv, fam)
        for need_vs, need_wv in ((True, True), (True, False), (False, True)):
            kw = dict(need_vs=need_vs, need_wv=need_wv)
            for a, b in zip(ss.vs_wv_counts(*inputs, **kw), ss.vs_wv_counts_reference(*inputs, **kw)):
                assert (a is None and b is None) or torch.equal(a, b), (fam, need_vs, need_wv)


def test_k2_unaligned_slices_of_one_allocation(cuda):
    """u, v and the data planes sliced from one buffer at offsets that are
    not multiples of 16, as stats_inputs passes yuv[1] and yuv[2]."""
    rng = np.random.default_rng(21)
    h, w = 64, 96
    buf = torch.from_numpy(rng.integers(0, 256, 5 * h * w + 7, np.uint8)).to(cuda)
    for off in (1, 3, 8, 16):
        u = buf[off:off + h * w].view(h, w)
        v = buf[off + h * w + 5:off + 2 * h * w + 5].view(h, w)
        data = buf[off:off + 3 * h * w].view(3, h, w)
        mask = buf[off + 2:off + 2 + h * w].view(h, w)
        vec = ss.vs_wv_counts.launches_vec
        got = ss.vs_wv_counts(u, v, data, mask)
        # v and the mask start 5 and 2 bytes past a 16-byte boundary at
        # best, so no call takes the cp.async form for both counts
        assert ss.vs_wv_counts.launches_vec == vec
        for a, b in zip(got, ss.vs_wv_counts_reference(u, v, data, mask)):
            assert torch.equal(a, b), off


def test_k2_every_rect_case(cuda):
    import chip_smoke

    for h, w in ((1080, 1920), (131, 270), (13, 17)):
        f = _kind_frame(h, w, "bars", 7)
        ds, yuv, *_ = tp.frame_pass_reference(
            torch.from_numpy(f.view(np.int32)[..., 0]).to(cuda), packed=True, cs=2, scale=1,
            with_overlays=False)
        for r in chip_smoke.rect_cases(h, w):
            rect = torch.tensor(r, dtype=torch.int32, device=cuda)
            for fam in (False, True):
                inputs = tp.stats_inputs(ds, yuv, fam)
                for need_vs, need_wv in ((True, True), (True, False), (False, True)):
                    kw = dict(need_vs=need_vs, need_wv=need_wv, rect=rect)
                    for a, b in zip(ss.vs_wv_counts(*inputs, **kw),
                                    ss.vs_wv_counts_reference(*inputs, **kw)):
                        assert (a is None and b is None) or torch.equal(a, b), (h, w, r, fam)


def test_fast_forms_taken_at_main_path_shapes(cuda):
    """At 3840x2160 scale 2 K1 takes the wide-load form, and K2 on its
    1920x1080 outputs the cp.async form for both counts."""
    x = torch.from_numpy(_kind_frame(2160, 3840, "random", 1).view(np.int32)[..., 0]).to(cuda)
    k1 = tp.frame_pass.launches_vec
    ds, yuv, *_ = tp.frame_pass(x, 1.0, packed=True, cs=2, scale=2, **ARGS)
    assert tp.frame_pass.launches_vec == k1 + 1
    k2 = ss.vs_wv_counts.launches_vec
    ss.vs_wv_counts(*tp.stats_inputs(ds, yuv, False))
    assert ss.vs_wv_counts.launches_vec == k2 + 1


@pytest.mark.parametrize("packed", [False, True])
def test_analyze_host_array_runs_on_the_card(cuda, packed):
    """A host array given to ``analyze`` without ``backend``, or with
    ``backend=default_backend()``, runs K1 and K2 on the card, equal to the
    tensor's call; with ``backend="xla"`` it runs on the CPU, equal too."""
    from obs_color_monitor_tpu_torch.ops.fused import analyze, default_backend

    f = _kind_frame(131, 270, "random", 5)
    host = f.view(np.int32)[..., 0] if packed else f
    kw = dict(cs=2, scale=2, need_vs=True, need_wv_rgb=True, need_hi_yuv=True)
    want = analyze(torch.from_numpy(np.ascontiguousarray(host)).to(cuda), **kw)
    assert default_backend() == "pallas"
    for extra in ({}, dict(backend=default_backend())):
        launches = (tp.frame_pass.launches, ss.vs_wv_counts.launches)
        got = analyze(host, **kw, **extra)
        assert (tp.frame_pass.launches, ss.vs_wv_counts.launches) == (launches[0] + 1,
                                                                       launches[1] + 2)
        for a, b in zip(got, want):
            assert (a is None and b is None) or (a.device == b.device and torch.equal(a, b))
    cpu = analyze(host, backend="xla", **kw)
    for a, b in zip(cpu, want):
        assert (a is None and b is None) or (a.device.type == "cpu" and torch.equal(a, b.cpu()))


@pytest.mark.parametrize("h,w,off", [(68, 144, 0), (68, 144, 1), (68, 132, 0), (70, 130, 0),
                                     (1080, 1920, 5)])
def test_k3_forms_and_single_outputs(cuda, h, w, off):
    """K3 in each of its forms (16-byte copies or plain loads, word or byte
    stores, a base that is not 16-byte aligned) with each output alone and
    all three, planar and packed, with and without a rect tensor."""
    rng = np.random.default_rng(h + w + off)
    buf = torch.from_numpy(rng.integers(0, 256, 4 * h * w + 16, np.uint8)).to(cuda)
    x = buf[off:off + 4 * h * w].view(4, h, w)
    rects = (None, torch.tensor((w // 5, h // 4, w - 3, h - 2), dtype=torch.int32, device=cuda))
    for rect in rects:
        for outputs in ((True, True, True), (True, False, False), (False, True, False),
                        (False, False, True)):
            for packed_out in (False, True):
                kw = dict(ARGS, rect=rect, packed_out=packed_out, outputs=outputs)
                vec = fo.fused_overlays_planes.launches_vec
                got = fo.fused_overlays_planes(x, 3.7, **kw)
                assert fo.fused_overlays_planes.launches_vec == vec + (off == 0 and w % 16 == 0)
                for a, b in zip(got, fo.fused_overlays_reference(x, 3.7, **kw)):
                    assert (a is None and b is None) or torch.equal(a, b), (rect, outputs)


def test_dock_settled_frame_launches_k3_once(cuda):
    """The settled Dock computes its three shown overlays in one K3 launch
    per frame, equal to the CPU Dock's panel."""
    from obs_color_monitor_tpu_torch.models import Dock

    rng = np.random.default_rng(14)
    docks = [Dock(DockConfig(show_focuspeaking=True), device=dev) for dev in (cuda, "cpu")]
    for i in range(3):
        f = rng.integers(0, 256, (96, 160, 4), np.uint8)
        launches = fo.fused_overlays_planes.launches
        panels = []
        for d in docks:
            d.push_frame(f)
            panels.append(d.render(width=256, height=900))
        assert fo.fused_overlays_planes.launches == launches + 1, i
        assert np.array_equal(*panels), i


BATCH_SHAPES = [(13, 17), (65, 144), (129, 131), (131, 270)]
TMS = (0.0, 1.5, 4.25)


def _at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """A copy of ``t`` inside a larger buffer, ``off`` elements from its
    start (a base that is not 16-byte aligned unless off = 0)."""
    buf = torch.empty(off + t.numel(), dtype=t.dtype, device=t.device)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


def _stack_plain(fn, *batched, **kw):
    """A batched kernel's plain version: the single-frame plain version on
    each frame, stacked."""
    outs = [fn(*(x[b] for x in batched), **kw) for b in range(batched[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(None if o[0] is None else torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


@pytest.mark.parametrize("off", [0, 1, 5])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("h,w", BATCH_SHAPES)
def test_batched_k1_k2_equal_per_frame_plain(cuda, h, w, packed, off):
    """K1 and K2 on a batch of 3 frames (one launch each) equal their
    single-frame plain versions frame by frame, each frame with its own
    clock, at odd and overhang shapes and on bases that are not 16-byte
    aligned."""
    frames = [_frame(h, w, 300 + b, flat=b == 1) for b in range(3)]
    arr = np.stack([f.view(np.int32)[..., 0] if packed else np.moveaxis(f, -1, 0)
                    for f in frames])
    x = _at_offset(torch.from_numpy(np.ascontiguousarray(arr)).to(cuda), off)
    tms = torch.tensor(TMS, dtype=torch.float32, device=cuda)
    for scale in (1, 2, 3):
        kw = dict(packed=packed, cs=1 + scale % 2, scale=scale, **ARGS)
        before = tp.frame_pass.launches
        got = tp.frame_pass(x, tms, **kw)
        assert tp.frame_pass.launches == before + 1
        ref = tuple(torch.stack([tp.frame_pass_reference(x[b], tms[b], **kw)[i]
                                 for b in range(3)]) for i in range(5))
        for a, b in zip(got, ref):
            assert torch.equal(a, b), scale
        for yuv_data in (False, True):
            inputs = tp.stats_inputs(got[0], got[1], yuv_data)
            for need_vs, need_wv in ((True, True), (True, False), (False, True)):
                kw2 = dict(need_vs=need_vs, need_wv=need_wv)
                before = ss.vs_wv_counts.launches
                counts = ss.vs_wv_counts(*inputs, **kw2)
                assert ss.vs_wv_counts.launches == before + 1
                per_frame = [ss.vs_wv_counts_reference(
                    *(None if t is None else t[b] for t in inputs), **kw2) for b in range(3)]
                for i, a in enumerate(counts):
                    want = None if per_frame[0][i] is None else torch.stack(
                        [o[i] for o in per_frame])
                    assert (a is None and want is None) or torch.equal(a, want), (
                        scale, yuv_data, need_vs, need_wv)


@pytest.mark.parametrize("off", [0, 1, 5])
@pytest.mark.parametrize("h,w", [(2, 8), (66, 142), (130, 256)])
def test_batched_nv12_decode_equals_per_frame_plain(cuda, h, w, off):
    """K4 and K5 on a batch of 3 NV12 / P010 frames, one launch each, equal
    their plain versions frame by frame."""
    import chip_smoke

    for bits in (8, 10):
        pairs = [chip_smoke.make_nv12(h, w, 40 + b, bits, msb=bits > 8) for b in range(3)]
        y = _at_offset(torch.from_numpy(np.stack([p[0] for p in pairs])).to(cuda), off)
        uv = _at_offset(torch.from_numpy(np.stack([p[1] for p in pairs])).to(cuda), off)
        if bits == 8:
            before = dec.nv12_decode.launches
            got = dec.nv12_decode(y, uv, cs=2)
            assert dec.nv12_decode.launches == before + 1
            want = _stack_plain(cv.nv12_packed_reference, y, uv, cs=2)
        else:
            before = dec.nv12_16_decode.launches
            got = dec.nv12_16_decode(y, uv, cs=1, shift=8)
            assert dec.nv12_16_decode.launches == before + 1
            want = _stack_plain(cv.nv12_16_packed_reference, y, uv, cs=1, shift=8)
        assert torch.equal(got, want), bits


def _bright_frame(h, w, seed):
    """A random frame whose top rows are bright enough for the zebra."""
    f = _frame(h, w, seed)
    f[: h // 3, :, :3] = np.maximum(f[: h // 3, :, :3], 215)
    return f


def _captured_cases(cuda):
    """(name, captured step, argument lists for tm = 1.0 and 4.0)."""
    from obs_color_monitor_tpu_torch import make_batched_step

    h, w = 136, 240
    f = _bright_frame(h, w, 21)
    nv = tuple(torch.from_numpy(a).to(cuda) for a in _nv12_pair(h, w, 22))
    packed = frame_from_numpy(f.view(np.uint32)[..., 0], "packed", cuda)
    dock = DockConfig(show_focuspeaking=True)
    rect = torch.tensor((20, 10, 100, 60), dtype=torch.int32, device=cuda)
    frames = torch.from_numpy(np.stack([_bright_frame(h, w, 23 + b) for b in range(3)])).to(cuda)
    tms = lambda t: torch.tensor([t, t + 1.5, t + 3.25], dtype=torch.float32, device=cuda)
    return [
        ("full packed", make_full_step(h, w, input_format="packed", device=cuda),
         lambda t: (packed, t)),
        ("full nv12", make_full_step(h, w, input_format="nv12", device=cuda),
         lambda t: (nv, torch.tensor(t, dtype=torch.float32, device=cuda))),
        ("dock nv12", make_dock_step(h, w, input_format="nv12", out_height=900, dock=dock,
                                     device=cuda), lambda t: (nv, t)),
        ("dock dynamic", make_dock_step(h, w, out_height=900, dynamic_roi=True, dock=dock,
                                        device=cuda),
         lambda t: (frame_from_numpy(f, "rgba", cuda), t, rect)),
        ("dock dynamic host rect", make_dock_step(h, w, out_height=900, dynamic_roi=True,
                                                  dock=dock, device=cuda),
         lambda t: (frame_from_numpy(f, "rgba", cuda), t, (20, 10, 100, 60))),
        ("batched", make_batched_step(h, w, device=cuda), lambda t: (frames, tms(t))),
    ]


def _nv12_pair(h, w, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (h, w), np.uint8)
    y[: h // 3] = np.maximum(y[: h // 3], 220)
    return y, rng.integers(100, 156, (h // 2, w), np.uint8)


def _host(out) -> dict:
    return {k: v.cpu().numpy() for k, v in out._asdict().items() if v is not None}


def test_captured_steps_equal_eager(cuda):
    """Every captured step (the full step, packed and NV12; the dock step,
    static and dynamic, with a rect tensor or host ints; the batched step)
    replays equal to its eager step at tm = 1.0 and 4.0, the zebra differs
    between the two (a frozen clock fails), and a result from an earlier
    call is unchanged after a later call."""
    def eager_args(args):  # the eager dynamic step takes the rect as a tensor
        return [torch.tensor(a, dtype=torch.int32, device=cuda) if isinstance(a, tuple)
                and all(isinstance(v, int) for v in a) else a for a in args]

    for name, step, args in _captured_cases(cuda):
        outs = []
        for t in (1.0, 4.0):
            got = _host(step(*args(t)))
            want = _host(step.eager(*eager_args(args(t))))
            assert got.keys() == want.keys(), name
            for k in want:
                assert np.array_equal(got[k], want[k]), (name, t, k)
            outs.append(got)
        field = "panel" if "dock" in name else "zebra"
        assert not np.array_equal(outs[0][field], outs[1][field]), name
        first = step(*args(1.0))
        step(*args(7.5))
        for k, v in _host(first).items():
            assert np.array_equal(v, outs[0][k]), (name, k)
        assert step.graphs == 1, name


# ---------------------------------------------------------------------------
# the host pipeline on the card: the driver's pinned uploads, a capture while
# the producer works, and the CLI's pipelined readback
# ---------------------------------------------------------------------------


def _driver_dock(device):
    from obs_color_monitor_tpu_torch import ROIConfig
    from obs_color_monitor_tpu_torch.models import Dock

    return Dock(DockConfig(show_focuspeaking=True), roi=ROIConfig(interleave=0),
                device=device)


def _nv12_frames(n, h=270, w=480, seed=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h * 3 // 2, w), np.uint8) for _ in range(n)]


def _direct_panels(device, bufs, h=270):
    """Panels of a Dock on ``device`` driven directly (push_nv12 + render)."""
    dock = _driver_dock(device)
    out = []
    for b in bufs:
        dock.push_nv12(b[:h], b[h:])
        out.append(dock.render())
    return out


def test_driver_pushes_while_worker_captures(cuda):
    """A driver on a fresh Dock (no graph yet), fed unpaced from this thread
    while the worker warms up and captures the settled step: no worker
    error, one settled graph, and every landed panel equal to a directly
    driven Dock fed the accepted frames in the same order."""
    from obs_color_monitor_tpu_torch.pipeline import PipelineDriver

    bufs = _nv12_frames(40)
    dock = _driver_dock(cuda)
    panels = []
    drv = PipelineDriver(dock=dock, on_panel=lambda p: panels.append(p.cpu().numpy()))
    accepted = []
    drv.start()
    try:
        for b in bufs:
            if drv.push_nv12(b[:270], b[270:]):
                accepted.append(b)
        drv.flush()
    finally:
        drv.stop()
    assert drv.stats["errors"] == 0
    assert drv.stats["pushed"] + drv.stats["dropped"] == len(bufs)
    assert len(panels) == len(accepted) == drv.stats["processed"]
    assert cuda.type != "cuda" or dock._settled.graphs == 1
    for i, want in enumerate(_direct_panels(cuda, accepted)):
        assert np.array_equal(panels[i], want), i


def test_driver_uploads_beside_a_capture_on_the_pools_capture_stream(cuda):
    """PyTorch's default-priority stream pool hands out its 32 streams in
    turn, and ``torch.cuda.graph``'s default capture stream is one of them:
    a driver whose upload stream is drawn 32 draws after it (a process that
    made enough streams first) uploads on that very stream.  Fed while its
    worker captures the settled step, such a driver still has no worker
    error and lands every accepted frame equal to a directly driven Dock's,
    because captures record on a stream of their own
    (``graphs.capture_stream``), which is none of the pool's."""
    from obs_color_monitor_tpu_torch import graphs
    from obs_color_monitor_tpu_torch.pipeline import PipelineDriver

    if torch.cuda.graph.default_capture_stream is None:
        torch.cuda.graph.default_capture_stream = torch.cuda.Stream(cuda)
    default = torch.cuda.graph.default_capture_stream.cuda_stream
    pool = {torch.cuda.Stream(cuda).cuda_stream for _ in range(32)}
    assert default in pool and graphs.capture_stream(cuda).cuda_stream not in pool
    bufs = _nv12_frames(40, seed=42)
    dock = _driver_dock(cuda)
    panels = []
    drv = PipelineDriver(dock=dock, on_panel=lambda p: panels.append(p.cpu().numpy()))
    accepted = []
    drv.start()
    try:
        while torch.cuda.Stream(cuda).cuda_stream != default:
            pass
        for _ in range(31):  # the next draw, the upload stream's, is the capture stream's
            torch.cuda.Stream(cuda)
        for b in bufs:
            if drv.push_nv12(b[:270], b[270:]):
                accepted.append(b)
        drv.flush()
    finally:
        drv.stop()
    assert drv._stager.stream.cuda_stream == default
    assert drv.stats["errors"] == 0 and dock._settled.graphs == 1
    assert len(panels) == len(accepted) == drv.stats["processed"]
    for i, want in enumerate(_direct_panels(cuda, accepted)):
        assert np.array_equal(panels[i], want), i


def test_capture_beside_a_thread_on_every_pool_stream(cuda):
    """While a step is captured, another thread records an event on each of
    the 32 streams of the default-priority pool (where a driver draws its
    upload stream) behind a copy and waits on it: every wait returns, the
    copies land, and the graph replays the step alone."""
    import threading

    from obs_color_monitor_tpu_torch.graphs import captured

    pool = [torch.cuda.Stream(cuda) for _ in range(32)]
    src = torch.arange(64, dtype=torch.int32, device=cuda)
    dst = [torch.zeros_like(src) for _ in pool]
    errors = []

    def other():
        try:
            for s, d in zip(pool, dst):
                ev = torch.cuda.Event()
                with torch.cuda.stream(s):
                    d.copy_(src)
                ev.record(s)
                ev.synchronize()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    def fn(t):
        if torch.cuda.is_current_stream_capturing():
            th = threading.Thread(target=other)
            th.start()
            th.join()
        return t * 2

    x = torch.arange(8, dtype=torch.float32, device=cuda)
    step = captured(fn, cuda)
    out = step(x)
    torch.cuda.synchronize()
    assert not errors, errors
    assert all(torch.equal(d, src) for d in dst)
    for d in dst:
        d.zero_()
    assert torch.equal(out, x * 2) and torch.equal(step(x + 1), (x + 1) * 2)
    torch.cuda.synchronize()
    assert all(not d.any() for d in dst)


def test_driver_pinned_ring_reuse(cuda):
    """More pushes than the pinned ring has slots (queue depth 1: 3 slots),
    a flush after each: every panel equal to a directly driven Dock's, one
    upload per push, the producer's time accounted."""
    from obs_color_monitor_tpu_torch.pipeline import NV12Frame, PipelineDriver

    bufs = _nv12_frames(10, seed=41)
    dock = _driver_dock(cuda)
    panels = []
    drv = PipelineDriver(dock=dock, queue_depth=1,
                         on_panel=lambda p: panels.append(p.cpu().numpy()))
    drv.start()
    try:
        for b in bufs:
            assert drv.push_nv12(b[:270], b[270:])
            drv.flush()
    finally:
        drv.stop()
    assert drv.stats["errors"] == 0 and len(panels) == 10
    for i, want in enumerate(_direct_panels(cuda, bufs)):
        assert np.array_equal(panels[i], want), i
    if cuda.type == "cuda":
        assert drv._stager.n_slots == 3 and drv.staging["uploads"] == 10
        assert drv.staging["host_copy_s"] > 0
        # a queued frame carries device planes and the upload's event
        probe = PipelineDriver(dock=_driver_dock(cuda))
        assert probe.push_nv12(bufs[0][:270], bufs[0][270:])
        queued = probe.queue.pop(timeout=1.0)
        assert isinstance(queued, NV12Frame) and queued.ready is not None
        assert queued.y.is_cuda and queued.uv.is_cuda
        queued.ready.synchronize()
        assert np.array_equal(queued.y.cpu().numpy(), bufs[0][:270])


def test_cli_pipelined_readback(cuda, monkeypatch, tmp_path):
    """The --live loop's readback: _Readback hands back each staged image
    one call late, equal to the image staged; the CLI's live dock publishes
    every frame once, in order, each equal to a directly driven Dock's
    panel."""
    from obs_color_monitor_tpu_torch import __main__ as cli
    from obs_color_monitor_tpu_torch.pipeline import live as live_mod

    rb = cli._Readback(cuda)
    imgs = [torch.full((6, 5, 4), i, dtype=torch.uint8, device=cuda) for i in range(5)]
    got = [rb.stage(img) for img in imgs] + [rb.take()]
    assert got[0] is None and rb.take() is None
    for i, g in enumerate(got[1:]):
        assert isinstance(g, np.ndarray) and (g == i).all(), i

    bufs = _nv12_frames(5, h=48, w=64, seed=42)
    clip = tmp_path / "clip.nv12"
    clip.write_bytes(b"".join(b.tobytes() for b in bufs))
    published = []
    orig = live_mod.MJPEGServer.publish
    monkeypatch.setattr(live_mod.MJPEGServer, "publish",
                        lambda self, img: (published.append(np.array(img)), orig(self, img))[1])
    rc = cli.main(["dock", "--input", str(clip), "--size", "64x48", "--scale", "1",
                   "--interleave", "0", "--frames", "5", "--live", "--port", "0",
                   "--fps", "240", "--out-width", "64", "--out-height", "360",
                   "--device", cuda.type])
    assert rc == 0 and len(published) == 5
    from obs_color_monitor_tpu_torch import ROIConfig
    from obs_color_monitor_tpu_torch.models import Dock

    dock = Dock(roi=ROIConfig(target_scale=1, interleave=0), device=cuda)
    for i, b in enumerate(bufs):
        dock.push_nv12(b[:48], b[48:])
        assert np.array_equal(published[i], dock.render(width=64, height=360)), i


@pytest.fixture
def nccl_meshes(cuda):
    """(batch mesh, rows mesh) over a world-size-1 NCCL group that
    ``make_mesh`` starts, destroyed after the test."""
    import torch.distributed as dist

    from obs_color_monitor_tpu_torch import parallel as par

    assert not dist.is_initialized()
    mb = par.make_mesh(device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        yield mb, par.make_mesh(axis=par.SPATIAL_AXIS, device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("h,w", [(67, 130), (128, 256)])
@pytest.mark.parametrize("comp", ["rgb", "yuv"])
def test_mesh_world_size_one_on_the_card(nccl_meshes, h, w, comp):
    """batch_analyze, spatial_analyze, spatial_pipeline and
    make_batched_step(mesh=) under NCCL equal the unsharded port on the CPU,
    with one K1 and one K2 launch each."""
    from obs_color_monitor_tpu_torch import make_batched_step
    from obs_color_monitor_tpu_torch import parallel as par
    from obs_color_monitor_tpu_torch.ops import overlays as ov
    from obs_color_monitor_tpu_torch.ops.fused import analyze

    mb, mr = nccl_meshes
    frames = np.stack([_frame(h, w, 40 + i) for i in range(2)])
    frames[0, ::5, :, :3] = 255
    y = comp == "yuv"

    def stats(f):
        res = analyze(torch.from_numpy(f), 2, scale=1, need_vs=True, need_wv_rgb=not y,
                      need_hi_rgb=not y, need_wv_yuv=y, need_hi_yuv=y)
        wv, hi = (res.wv_yuv, res.hi_yuv) if y else (res.wv_rgb, res.hi_rgb)
        return [res.vs_counts, hi.to(torch.uint32), wv]

    k1, k2 = tp.frame_pass.launches, ss.vs_wv_counts.launches
    got = par.batch_analyze(frames, mb, cs=2, components=comp)
    assert (tp.frame_pass.launches - k1, ss.vs_wv_counts.launches - k2) == (1, 1)
    for b in range(2):
        for g, r in zip(got, stats(frames[b])):
            assert torch.equal(g[b].cpu(), r)
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(frames[0], -1, 0)))
    want = stats(frames[0])
    assert all(torch.equal(g.cpu(), r) for g, r in
               zip(par.spatial_analyze(frames[0], mr, cs=2, components=comp), want))
    for tm in (1.0, 4.0):
        out = par.spatial_pipeline(frames[0], mr, cs=2, tm=tm, components=comp, **ARGS)
        want_ov = [ov.zebra_planes(planes, 0.75, 1.0, tm, 2), ov.falsecolor_planes(planes, 1),
                   ov.focus_peaking_planes(planes, 3062, (255, 84, 0, 255))]
        for g, r in zip(out, want + want_ov):
            assert torch.equal(g.cpu(), r)
    step = make_batched_step(h, w, mesh=mb, scale=2, input_format="rgba")
    assert step.device == cuda_device(mb)
    tms = torch.tensor([0.5, 2.5], device=cuda_device(mb))
    got = step(torch.from_numpy(frames).to(cuda_device(mb)), tms).to_numpy()
    want = make_batched_step(h, w, scale=2, input_format="rgba", device="cpu")(
        torch.from_numpy(frames), tms.cpu()).to_numpy()
    for key in want:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("comp", ["rgb", "yuv"])
def test_mesh_paths_replay_one_graph(nccl_meshes, comp):
    """At world size 1 under NCCL each mesh path is one captured step: on
    two frames and at tm 1.0 and 4.0 (a float, then a 0-d tensor) every
    call equals its ``.eager`` body and the unsharded port on the CPU, each
    step holds one graph after the repeated calls, and every call counts
    one K1 and one K2 launch and no K3 (no halo at one rank)."""
    from obs_color_monitor_tpu_torch import parallel as par
    from obs_color_monitor_tpu_torch.ops import overlays as ov
    from obs_color_monitor_tpu_torch.ops.fused import analyze
    from obs_color_monitor_tpu_torch.parallel import mesh as pm

    mb, mr = nccl_meshes
    dev = cuda_device(mb)
    h, w = 130, 256
    y = comp == "yuv"
    frames = [_bright_frame(h, w, 60 + i) for i in range(2)]
    frames[1][::7, :, :3] = 255

    def stats(f):
        res = analyze(torch.from_numpy(f), 2, scale=1, need_vs=True, need_wv_rgb=not y,
                      need_hi_rgb=not y, need_wv_yuv=y, need_hi_yuv=y)
        wv, hi = (res.wv_yuv, res.hi_yuv) if y else (res.wv_rgb, res.hi_rgb)
        return [res.vs_counts, hi.to(torch.uint32), wv]

    def overlays(f, tm):
        planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 0)))
        return [ov.zebra_planes(planes, 0.75, 1.0, tm, 2), ov.falsecolor_planes(planes, 1),
                ov.focus_peaking_planes(planes, 3062, (255, 84, 0, 255))]

    kw = dict(cs=2, components=comp)
    steps = {"batch": pm._mesh_step("batch_analyze", mb, **kw),
             "spatial": pm._mesh_step("spatial_analyze", mr, **kw),
             "pipeline": pm._mesh_step("spatial_pipeline", mr, **kw, **ARGS)}
    cases = []  # (step, its call, its eager call, the CPU's outputs)
    for i, f in enumerate(frames):
        x = torch.from_numpy(f).to(dev)
        batch = torch.from_numpy(np.stack([f, frames[1 - i]])).to(dev)
        cases += [
            (steps["batch"], lambda b=batch: par.batch_analyze(b, mb, **kw),
             lambda b=batch: steps["batch"].eager(b),
             [torch.stack(o) for o in zip(stats(f), stats(frames[1 - i]))]),
            (steps["spatial"], lambda x=x: par.spatial_analyze(x, mr, **kw),
             lambda x=x: steps["spatial"].eager(x), stats(f))]
        for tm in (1.0, 4.0):
            clock = tm if i == 0 else torch.tensor(tm, dtype=torch.float32, device=dev)
            cases.append((steps["pipeline"],
                          lambda x=x, c=clock: par.spatial_pipeline(x, mr, tm=c, **kw, **ARGS),
                          lambda x=x, c=clock: steps["pipeline"].eager(x, c),
                          stats(f) + overlays(f, tm)))
    zebras = []
    for step, call, eager, want in cases:
        k1, k2, k3 = (tp.frame_pass.launches, ss.vs_wv_counts.launches,
                      fo.fused_overlays_planes.launches)
        got = call()
        assert (tp.frame_pass.launches - k1, ss.vs_wv_counts.launches - k2,
                fo.fused_overlays_planes.launches - k3) == (1, 1, 0)
        assert len(got) == len(want)
        for g, e, r in zip(got, eager(), want):
            assert torch.equal(g, e) and torch.equal(g.cpu(), r)
        if len(got) == 6:
            zebras.append(got[3].cpu())
    assert not torch.equal(zebras[0], zebras[1])  # the clock moved the zebra
    assert all(step.graphs == 1 for step in steps.values())


def cuda_device(mesh):
    from obs_color_monitor_tpu_torch.parallel import mesh_device

    return mesh_device(mesh)


def test_mesh_refuses_a_cpu_mesh_on_an_nccl_group(nccl_meshes):
    from obs_color_monitor_tpu_torch import parallel as par

    with pytest.raises(ValueError):
        par.make_mesh(device="cpu")


@pytest.mark.parametrize("h,w,cuts", [(67, 130, (33,)), (64, 144, (16, 32, 48)),
                                      (9, 17, (1, 2, 8)), (130, 256, (65,))])
def test_mesh_halo_pieces_on_the_card(cuda, h, w, cuts):
    """spatial_pipeline's per-rank overlay pieces, for row blocks cut at
    ``cuts``: K1 on each block with its offset clock, focus peaking's
    boundary rows corrected by K3 from the neighbours' rows, equal to the
    whole frame's overlays; the code that runs only at more than one rank."""
    from obs_color_monitor_tpu_torch.ops.convert import packed_view
    from obs_color_monitor_tpu_torch.parallel.mesh import peaking_boundary_rows

    f = _frame(h, w, h + w)
    f[::4, :, :3] = 255
    x = torch.from_numpy(f).to(cuda)
    kw = dict(packed=True, cs=2, scale=1, with_overlays=True, **ARGS)
    tm = 1000.37
    whole = tp.frame_pass(packed_view(x), tm, **kw)
    edges = (0, *cuts, h)
    parts = []
    k3 = fo.fused_overlays_planes.launches
    for a, b in zip(edges[:-1], edges[1:]):
        clock = (torch.full((), tm, dtype=torch.float32, device=cuda)
                 + torch.full((), float(a), dtype=torch.float32, device=cuda))
        ds, _, zb, fc, fp = tp.frame_pass(packed_view(x[a:b].contiguous()), clock, **kw)
        above = whole[0][:, a - 1:a] if a else None
        below = whole[0][:, b:b + 1] if b < h else None
        parts.append((zb, fc, peaking_boundary_rows(fp, ds, above, below, ARGS["peak_th"],
                                                    ARGS["peak_rgba"])))
    assert fo.fused_overlays_planes.launches > k3
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts], dim=1), whole[2 + i])


def test_overlay_scopes_apply_on_the_card(cuda):
    """The filter flavour ``apply(frame)`` of Zebra, FalseColor (plain, with
    a LUT, with a key beside the image) and FocusPeaking on the card equals
    the same scope on the CPU; the K3 route launches K3 once a call."""
    from obs_color_monitor_tpu_torch import FalseColorConfig, FocusPeakingConfig, ShowKey
    from obs_color_monitor_tpu_torch.models import FalseColor, FocusPeaking, Zebra

    f = _bright_frame(270, 480, 70)
    lut = np.random.default_rng(3).integers(0, 256, (9, 4), np.uint8)
    for make, k3 in ((lambda d: Zebra(device=d), 1), (lambda d: FalseColor(device=d), 1),
                     (lambda d: FalseColor(FalseColorConfig(use_lut=True, lut=lut), device=d), 0),
                     (lambda d: FalseColor(FalseColorConfig(show_key=ShowKey.OUTSIDE),
                                           device=d), 1),
                     (lambda d: FocusPeaking(FocusPeakingConfig(peaking_threshold=0.02),
                                             device=d), 1)):
        card, host = make(cuda), make("cpu")
        if isinstance(card, Zebra):
            card.tick(0.5)
            host.tick(0.5)
        before = fo.fused_overlays_planes.launches
        got = card.apply(torch.from_numpy(f).to(cuda))
        assert fo.fused_overlays_planes.launches - before == k3
        assert torch.equal(got.cpu(), host.apply(f))
        assert torch.equal(card.apply(f).cpu(), got.cpu())


def test_histogram_render_ties_on_the_card(cuda):
    """Every level an exact tie of the fill test (count * 2H == (2H - 2 row
    - 1) * hi_max): the card's render equals the CPU's and golden's (a
    host-scalar divisor made CUDA multiply by a rounded reciprocal)."""
    from obs_color_monitor_tpu_torch.golden import render as golden_render
    from obs_color_monitor_tpu_torch.ops import render as rd

    H, hi = 200, 400
    counts = np.zeros((3, 256), np.float32)
    counts[:, :200] = 2 * H - 2 * np.arange(200) - 1  # row r ties at level 2H - 2r - 1
    hm = np.full(3, hi, np.float32)
    for display, n in ((0, 3), (1, 3), (2, 3), (0, 1)):
        got = rd.render_histogram(torch.from_numpy(counts).to(cuda), torch.from_numpy(hm).to(cuda),
                                  H, display, n, False).cpu()
        cpu = rd.render_histogram(torch.from_numpy(counts), torch.from_numpy(hm), H, display, n,
                                  False)
        assert torch.equal(got, cpu)
        assert np.array_equal(got.numpy(), golden_render.render_histogram(
            counts, hm, H, display, n, False))


def test_captured_steps_take_host_arguments(cuda):
    """chip_smoke's host-argument phase at 960x540: a numpy u32 frame with
    an ``np.float32`` clock through the full step, numpy NV12 and P010
    pairs through the dock step, a numpy int32 rect and a tuple of
    ``np.int64`` through the dynamic dock step and a numpy batch with
    numpy clocks through the batched step, each replayed equal to the
    tensor call with the same launches and no second graph."""
    import chip_smoke

    by_path = chip_smoke.phase_host_args(cuda, h=540, w=960, roi=(40, 20, 300, 200))
    assert len(by_path) == 5
    assert all(c["K1"] >= 1 and c["K2"] >= 1 for c in by_path.values())


def test_service_unit_rgba_dock_on_the_card(cuda):
    """chip_smoke's service-unit phase at 960x540: the unit's command in
    process, on a raw RGBA file of 8 frames, its PNG equal to a directly
    driven Dock's panel, K1, K2 and K3 launched (the phase raises
    otherwise)."""
    import chip_smoke

    by_path, png = chip_smoke.phase_service_unit(cuda, h=540, w=960)
    counts = by_path["service unit dock rgba"]
    assert min(counts[k] for k in ("K1", "K2", "K3")) >= 1
    assert png.startswith(b"\x89PNG")


# KC, the dynamic step's panel assembly in one launch (ops/compose.py), on
# every slot kind: configuration -> (make_dock_step keywords, panel size)
_LUT = np.random.default_rng(3).integers(0, 256, (40, 4), np.uint8)
COMPOSE_LAYOUTS = {
    "overlay": (dict(dock=DockConfig(show_focuspeaking=True)), (256, 900)),
    "parade_key_outside": (dict(
        dock=DockConfig(show_focuspeaking=True),
        waveform=cfg.WaveformConfig(display=cfg.DisplayMode.PARADE),
        falsecolor=cfg.FalseColorConfig(show_key=cfg.ShowKey.OUTSIDE)), (256, 900)),
    "stack_key_below_actual_size": (dict(
        dock=DockConfig(show_focuspeaking=True),
        waveform=cfg.WaveformConfig(display=cfg.DisplayMode.STACK),
        falsecolor=cfg.FalseColorConfig(show_key=cfg.ShowKey.BELOW),
        focuspeaking=cfg.FocusPeakingConfig(actual_size=True)), (200, 1100)),
    "lut_key_left": (dict(
        dock=DockConfig(show_focuspeaking=True),
        falsecolor=cfg.FalseColorConfig(show_key=cfg.ShowKey.LEFT, use_lut=True, lut=_LUT)),
        (333, 777)),
    "lut_hidden_scopes": (dict(
        dock=DockConfig(show_vectorscope=False, show_histogram=False, show_focuspeaking=True),
        falsecolor=cfg.FalseColorConfig(use_lut=True, lut=_LUT)), (130, 501)),
    "panel_too_short": (dict(dock=DockConfig(show_focuspeaking=True)), (97, 5)),
}
# full, quarter, one pixel, empty, negative, reversed, past the edge and
# odd-aligned, at the 120x68 capture
COMPOSE_RECTS = [(0, 0, 120, 68), (30, 17, 90, 51), (64, 33, 65, 34), (50, 20, 50, 40),
                 (-9, -5, 31, 22), (90, 50, 20, 10), (101, 55, 700, 300), (3, 1, 118, 67),
                 (17, 9, 54, 30), (0, 0, 1, 68)]


def _recorded_assembly(step, frame, rect, monkeypatch):
    """The step's slot table, images and rect as the kernel's wrapper
    checks them, from one eager call, and the step's output."""
    from obs_color_monitor_tpu_torch.ops import compose

    seen, check = {}, compose.check_panel_inputs

    def spy(table, images, r):
        seen.update(table=table, images=dict(images), rect=r)
        return check(table, images, r)

    with monkeypatch.context() as mp:
        mp.setattr(compose, "check_panel_inputs", spy)
        out = step.eager(frame, 1.25, rect)
    return seen["table"], seen["images"], seen["rect"], out


@pytest.mark.parametrize("layout", sorted(COMPOSE_LAYOUTS))
def test_dock_compose_kernel_equals_plain_assembly(cuda, layout, monkeypatch):
    """KC's panel equals the plain assembly's on the same images, byte for
    byte, at every rect of the sweep, in int32 and in 64-bit index math;
    the dynamic step launches it once and its panel equals the CPU step's,
    which launches nothing."""
    from obs_color_monitor_tpu_torch.ops import compose

    kw, (ow, oh) = COMPOSE_LAYOUTS[layout]
    f = _frame(136, 240, 21)
    steps = {dev: make_dock_step(136, 240, out_width=ow, out_height=oh, dynamic_roi=True,
                                 device=dev, **kw) for dev in (cuda, "cpu")}
    for r in COMPOSE_RECTS:
        rect = torch.tensor(r, dtype=torch.int32, device=cuda)
        n = compose.compose_panel.launches
        table, images, got_rect, out = _recorded_assembly(
            steps[cuda], torch.from_numpy(f).to(cuda), rect, monkeypatch)
        assert compose.compose_panel.launches == n + 1 and got_rect is rect
        plain = compose.assemble_dyn_panel(table, images, rect)
        assert torch.equal(out.panel, plain), (layout, r)
        wide = compose.compose_panel(table._replace(wide=True), images, rect)
        torch.cuda.synchronize()
        assert torch.equal(wide, plain), (layout, r)
        n = compose.compose_panel.launches
        ref = steps["cpu"](torch.from_numpy(f), 1.25, torch.tensor(r, dtype=torch.int32))
        assert compose.compose_panel.launches == n
        assert np.array_equal(out.panel.cpu().numpy(), ref.panel.numpy()), (layout, r)


def test_dock_compose_captured_step_replays_ten_rects(cuda):
    """One captured dynamic step with KC in it, replayed over ten rects:
    each panel equals the CPU step's, one KC launch per replay, one graph."""
    from obs_color_monitor_tpu_torch.ops import compose

    kw, (ow, oh) = COMPOSE_LAYOUTS["parade_key_outside"]
    rng = np.random.default_rng(22)
    y = rng.integers(0, 256, (136, 240), np.uint8)
    uv = rng.integers(0, 256, (68, 240), np.uint8)
    steps = {dev: make_dock_step(136, 240, input_format="nv12", out_width=ow, out_height=oh,
                                 dynamic_roi=True, device=dev, **kw) for dev in (cuda, "cpu")}
    x = frame_from_numpy((y, uv), "nv12", cuda)
    steps[cuda](x, 0.5, torch.tensor(COMPOSE_RECTS[1], dtype=torch.int32, device=cuda))
    for r in COMPOSE_RECTS:
        n = compose.compose_panel.launches
        got = steps[cuda](x, 0.5, torch.tensor(r, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert compose.compose_panel.launches == n + 1
        ref = steps["cpu"](frame_from_numpy((y, uv), "nv12", "cpu"), 0.5,
                           torch.tensor(r, dtype=torch.int32))
        for k, v in ref.to_numpy().items():
            assert np.array_equal(got.to_numpy()[k], v), (r, k)
    assert steps[cuda].graphs == 1


def test_dock_compose_counts_fused_frames(cuda):
    """A drag through a Dock on the card: every ``dock.dynamic`` frame
    makes one KC launch."""
    from obs_color_monitor_tpu_torch.models import Dock
    from obs_color_monitor_tpu_torch.ops import compose
    from obs_color_monitor_tpu_torch.pipeline import profiler

    dock = Dock(DockConfig(), roi=cfg.ROIConfig(interleave=0, target_scale=2, x0=8, y0=4,
                                                x1=32, y1=16), device=cuda)
    rng = np.random.default_rng(23)
    planes = [rng.integers(0, 256, (72, 96), dtype=np.uint8) for _ in range(6)]
    for b in planes[:2]:
        dock.push_nv12(b[:48], b[48:])
        dock.render_async()
    x0, y0, w, h, _, _ = dock._rects["roi"]
    n = compose.compose_panel.launches
    profiler.reset()
    profiler.enable(True)
    try:
        dock.mouse_move(x0 + w // 2, y0 + h // 2)
        dock.mouse_down(x0 + w // 2, y0 + h // 2)
        for k, b in enumerate(planes[2:]):
            dock.mouse_move(x0 + w // 2 + 2 * (k + 1), y0 + h // 2 + k + 1)
            dock.push_nv12(b[:48], b[48:])
            dock.render_async()
        torch.cuda.synchronize()
        snap = profiler.snapshot()
    finally:
        profiler.enable(False)
        profiler.reset()
    dynamic = sum(s["name"] == "dock.dynamic" for s in snap["spans"])
    assert dynamic == 4 and compose.compose_panel.launches - n == dynamic


# KC on a static table (ops/compose.compose_panel): the settled route's
# and the static step's panel in one launch
@pytest.mark.parametrize("case", ["full_preview_packed_13x17", "cropped_preview_rgba_129x131",
                                  "shaded_rect_w17", "shaded_empty_rect", "actual_size_cropped",
                                  "actual_size_whole_129x131", "too_short_overlapping",
                                  "left_out_keep_height", "window_past_the_source"])
def test_static_compose_kernel_equals_the_chain(cuda, case):
    """Every case of the CPU tests' static panels: one launch draws the
    panel of the plain version on the same sources, byte for byte, in
    int32 and in 64-bit index math, and the CPU's."""
    from test_torch_dock_compose import STATIC_CASES, _static_sources

    from obs_color_monitor_tpu_torch.ops import compose

    assert case in STATIC_CASES
    images, boxes, out = _static_sources(case)
    on_card = {n: compose.Preview(img.planes.to(cuda), img.rect)
               if isinstance(img, compose.Preview) else img.to(cuda)
               for n, img in images.items()}
    want = compose.assemble_panel(images, boxes, *out)
    n = compose.compose_panel.launches
    got = compose.assemble_panel(on_card, boxes, *out)
    assert compose.compose_panel.launches == n + 1
    table, sources = compose.static_inputs(on_card, boxes, *out)
    plain = compose.assemble_static_panel(table, sources)
    wide = compose.compose_panel(table._replace(wide=True), sources)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(wide, plain), case
    assert np.array_equal(got.cpu().numpy(), want.numpy()), case


def _static_dock(device, h, w, interleave=0, **show):
    """A streaming Dock on NV12 frames at the benchmark's settings (a
    512x1536 panel, stats at target_scale 2), settled after three frames."""
    from obs_color_monitor_tpu_torch.models import Dock

    dock = Dock(DockConfig(width=512, height=1536, **show),
                roi=cfg.ROIConfig(interleave=interleave, target_scale=2), device=device)
    rng = np.random.default_rng(h + w + interleave)
    frames = [rng.integers(0, 256, (h * 3 // 2, w), np.uint8) for _ in range(4)]
    for b in frames[:3]:
        dock.push_nv12(b[:h], b[h:])
        dock.render_async()
    return dock, frames


@pytest.mark.parametrize("layout", ["uhd", "desktop", "uhd_interleave1"])
def test_static_compose_dock_frames(cuda, layout, monkeypatch):
    """The benchmark's settled docks on the card (4K NV12 with focus
    peaking; the 2560x1440 desktop without it; 4K at interleave 1): a
    settled frame's replay and a skipped frame's eager composite each make
    one static KC launch, counted per replay, with one graph for every
    frame; each panel equals the same Dock's with the plain version of the
    table (captured and eager)."""
    from obs_color_monitor_tpu_torch.ops import compose
    from obs_color_monitor_tpu_torch.pipeline import profiler

    h, w, inter, show = {"uhd": (2160, 3840, 0, dict(show_focuspeaking=True)),
                         "desktop": (1440, 2560, 0, {}),
                         "uhd_interleave1": (2160, 3840, 1, dict(show_focuspeaking=True))}[layout]

    def plain(table, images, rect=None):
        assert rect is None
        return compose.assemble_static_panel(table, images)

    plain.launches = 0  # a capture reads and restores it
    dock, frames = _static_dock(cuda, h, w, inter, **show)
    step = dock._settled
    got, want = [], []
    profiler.reset()
    profiler.enable(True)
    try:
        for k in range(6):
            b = frames[k % 4]
            n = compose.compose_panel.launches
            dock.push_nv12(b[:h], b[h:])
            got.append(dock.render_async().cpu())
            assert compose.compose_panel.launches == n + 1, k
        snap = profiler.snapshot()
    finally:
        profiler.enable(False)
        profiler.reset()
    assert dock._settled is step and not snap["counters"].get("step.captures")
    assert snap["counters"].get("dock.skipped", 0) == 3 * inter
    with monkeypatch.context() as mp:
        mp.setattr(compose, "compose_panel", plain)
        ref, _ = _static_dock(cuda, h, w, inter, **show)
        for k in range(6):
            b = frames[k % 4]
            ref.push_nv12(b[:h], b[h:])
            want.append(ref.render_async().cpu())
    assert dock._settled.graphs == 1 and ref._settled.graphs == 1
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (layout, k)


# KR, the stats scopes' images in one launch (ops/render.draw_stat_images),
# against the plain chain on the card: every display mode, component
# family, colour type, level mode, logscale and zoom, at the odd widths and
# the main paths' waveform widths
_KR_FAMILIES = (cfg.Components.RGB, cfg.Components.Y, cfg.Components.UV, cfg.Components.YUV,
                cfg.Components(0x05))
_KR_LEVELS = ((0, 0), (300, 0), (0, 25))  # (level_fixed, level_ratio_permille): auto, pixel, ratio


def _kr_jobs(device, width, seed, display, comps, white, level, logscale, zoom, n_pixels,
             level_height=77, flat=False):
    """One vectorscope, waveform and histogram job on ``device`` with the
    graticules their scopes draw."""
    from obs_color_monitor_tpu_torch.ops import graticule as gr
    from obs_color_monitor_tpu_torch.ops import render as rd

    rng = np.random.default_rng(seed)
    vs = rng.integers(0, 256, (256, 256), np.uint8)
    wv = rng.integers(0, 256, (3, 256, width), np.uint8)
    hi = rng.integers(0, 5000 if not flat else 2, (3, 256)).astype(np.int32)
    hi[:, :7] = 0
    on = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n, sel, yuv = comps.n_components, comps.channel_select(), comps.is_yuv
    fixed, ratio = level
    return [
        rd.vectorscope_job(on(vs), on(gr.vectorscope_graticule(1 + seed % 3, seed % 2 == 0,
                                                                1 + seed % 2)),
                           3 + seed % 20, 1 + seed % 2, white, zoom),
        rd.waveform_job(on(wv), on(gr.waveform_graticule(1 + seed % 4, width, display, n)), sel,
                        1 + seed % 9, display, n, yuv),
        rd.histogram_job(on(hi), on(gr.histogram_graticule(3, 10.0, level_height, display, n,
                                                           fixed, ratio, logscale)),
                         sel, n_pixels, fixed, ratio, logscale, level_height, display, n, yuv),
    ]


def _kr_equal(jobs, device):
    """KR's images (one launch) against the plain chain's on the card and
    on the CPU, byte for byte."""
    from obs_color_monitor_tpu_torch.ops import render as rd

    n = rd.draw_stat_images.launches
    got = rd.draw_stat_images(jobs)
    assert rd.draw_stat_images.launches == n + 1
    cpu_jobs = [j._replace(counts=j.counts.cpu(), graticule=None if j.graticule is None else
                           j.graticule.cpu(), n_pixels=j.n_pixels.cpu() if isinstance(
                               j.n_pixels, torch.Tensor) else j.n_pixels) for j in jobs]
    for job, img, cj in zip(jobs, got, cpu_jobs):
        assert torch.equal(img, rd.draw_stat_plain(job)), job._replace(counts=None,
                                                                       graticule=None)
        assert torch.equal(img.cpu(), rd.draw_stat_plain(cj)), job.kind


@pytest.mark.parametrize("width", [13, 17, 130, 131, 132, 1280, 1920])
def test_scope_render_kernel_equals_plain(cuda, width):
    """KR against the plain chain over every display mode x component
    family x colour type x level mode (a host and a device pixel count in
    ratio mode) x logscale x zoom, at the odd widths and the dock's 4K and
    desktop waveform widths."""
    import itertools

    cases = itertools.product((0, 1, 2), _KR_FAMILIES, (False, True), _KR_LEVELS,
                              (False, True), (1.0, 1.01, 2.5))
    for k, (display, comps, white, level, logscale, zoom) in enumerate(cases):
        n_px = 131 * 97 if k % 2 else torch.tensor(131 * 97 + k, dtype=torch.int64, device=cuda)
        _kr_equal(_kr_jobs(cuda, width, k, display, comps, white, level, logscale, zoom, n_px,
                           level_height=50 + k % 3, flat=k % 5 == 0), cuda)
    # one job and two jobs a launch, in either order
    jobs = _kr_jobs(cuda, width, 7, 2, cfg.Components.YUV, False, (0, 0), False, 2.0, 99)
    for sub in (jobs[:1], jobs[1:2], jobs[2:], jobs[2::-2], jobs[1:]):
        _kr_equal(sub, cuda)


def test_scope_render_empty_waveform(cuda):
    """A waveform of no columns draws an empty image, as the plain chain
    does, and the other jobs of its table still draw in one launch; a
    table of only empty images launches nothing."""
    from obs_color_monitor_tpu_torch.ops import render as rd

    jobs = _kr_jobs(cuda, 16, 9, 2, cfg.Components.RGB, False, (0, 0), False, 1.0, 10)
    empty = jobs[1]._replace(counts=jobs[1].counts[:, :, :0].contiguous(), graticule=None)
    n = rd.draw_stat_images.launches
    got = rd.draw_stat_images([jobs[0], empty, jobs[2]])
    assert rd.draw_stat_images.launches == n + 1
    assert got[1].shape == (256, 0, 4) == rd.draw_stat_plain(empty).shape
    for job, img in zip((jobs[0], jobs[2]), (got[0], got[2])):
        assert torch.equal(img, rd.draw_stat_plain(job))
    assert rd.draw_stat_images([empty])[0].shape == (256, 0, 4)
    assert rd.draw_stat_images.launches == n + 1


def test_scope_render_graph_replays_new_counts(cuda):
    """KR captured in a CUDA graph, replayed after the counts and the
    device pixel count change: each replay equals the plain chain on the
    new values."""
    from obs_color_monitor_tpu_torch.ops import render as rd

    n_px = torch.tensor(4000, dtype=torch.int64, device=cuda)
    jobs = _kr_jobs(cuda, 131, 3, 1, cfg.Components.RGB, False, (0, 25), False, 2.5, n_px)
    auto = _kr_jobs(cuda, 131, 4, 2, cfg.Components.YUV, True, (0, 0), True, 1.0, 1)[2]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rd.draw_stat_images(jobs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = rd.draw_stat_images(jobs)
    rng = np.random.default_rng(5)
    for k in range(4):
        for j in jobs:
            hi = 4 if j.counts.dtype == torch.uint8 and k == 3 else (256 if j.counts.dtype ==
                                                                     torch.uint8 else 9000)
            j.counts.copy_(torch.from_numpy(rng.integers(0, hi, tuple(j.counts.shape)).astype(
                np.uint8 if j.counts.dtype == torch.uint8 else np.int32)))
        n_px.fill_(1000 * (k + 1) + 7)
        graph.replay()
        torch.cuda.synchronize()
        for job, img in zip(jobs, outs):
            assert torch.equal(img, rd.draw_stat_plain(job)), (k, job.kind)
    # and the auto level mode under logscale
    _kr_equal([auto], cuda)


def test_scope_render_dynamic_step_ratio_mode(cuda):
    """The dynamic dock step with the histogram in ratio mode, its pixel
    count the rect's, in device memory: one captured graph replayed over
    rects, one KR launch a replay, each output equal to the CPU step's."""
    from obs_color_monitor_tpu_torch.ops import render as rd

    kw = dict(histogram=cfg.HistogramConfig(level_mode=cfg.LevelMode.RATIO,
                                            level_ratio_value=1.5),
              waveform=cfg.WaveformConfig(display=cfg.DisplayMode.PARADE),
              vectorscope=cfg.VectorscopeConfig(zoom=1.8))
    f = _frame(136, 240, 31)
    steps = {dev: make_dock_step(136, 240, out_width=256, out_height=900, dynamic_roi=True,
                                 device=dev, **kw) for dev in (cuda, "cpu")}
    x = torch.from_numpy(f).to(cuda)
    steps[cuda](x, 0.5, torch.tensor(COMPOSE_RECTS[1], dtype=torch.int32, device=cuda))
    for r in COMPOSE_RECTS:
        n = rd.draw_stat_images.launches
        got = steps[cuda](x, 0.5, torch.tensor(r, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert rd.draw_stat_images.launches == n + 1
        ref = steps["cpu"](torch.from_numpy(f), 0.5, torch.tensor(r, dtype=torch.int32))
        for k, v in ref.to_numpy().items():
            assert np.array_equal(got.to_numpy()[k], v), (r, k)
    assert steps[cuda].graphs == 1


def test_captured_step_holds_the_collector_off(cuda):
    """A dead reference cycle that holds a captured graph is not collected
    while another step is captured (a Dock and its settled step are such a
    cycle): CUDA does not permit destroying a graph mid-capture, and the
    capture would fail.  The collector runs again after."""
    import gc

    from obs_color_monitor_tpu_torch.graphs import captured

    x = torch.arange(8, dtype=torch.float32, device=cuda)
    old = captured(lambda t: t * 2, cuda)
    old(x)
    cycle = [old]
    cycle.append(cycle)
    holder = [cycle]
    del old, cycle
    seen = []

    def fn(t):
        if torch.cuda.is_current_stream_capturing() and holder:
            holder.clear()  # the cycle is garbage from here
            seen.append(gc.isenabled())
            junk = [[] for _ in range(50000)]  # allocations enough for full collections
            del junk
        return t + 1

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        out = captured(fn, cuda)(x)
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert seen == [False] and gc.isenabled()
    assert torch.equal(out, x + 1)
    gc.collect()


@pytest.mark.parametrize("level", [(0, 0), (0, 25), (500, 0)])
def test_scope_render_full_step_one_launch_a_frame(cuda, level):
    """The full step's replays and the batched step's (B = 2) draw each
    frame's three images in one KR launch, every output equal to the same
    step on the CPU."""
    from obs_color_monitor_tpu_torch import make_batched_step
    from obs_color_monitor_tpu_torch.ops import render as rd

    modes = {(0, 25): cfg.LevelMode.RATIO, (500, 0): cfg.LevelMode.PIXEL}
    hist = cfg.HistogramConfig(level_mode=modes.get(level, cfg.LevelMode.AUTO),
                               logscale=level == (0, 0), components=cfg.Components.YUV)
    h, w = 129, 262
    frames = np.stack([_frame(h, w, 60 + k) for k in range(2)])
    for make, args, per_call in (
            (make_full_step, lambda d, t: (torch.from_numpy(frames[t]).to(d), 0.5 + t), 1),
            (make_batched_step, lambda d, t: (torch.from_numpy(np.roll(frames, t, 0)).to(d),
                                              torch.tensor([0.5, 1.5 + t], device=d)), 2)):
        step, ref = (make(h, w, scale=2, histogram=hist, device=d) for d in (cuda, "cpu"))
        step(*args(cuda, 0))  # the capture
        for t in range(2):
            n = rd.draw_stat_images.launches
            got = step(*args(cuda, t))
            torch.cuda.synchronize()
            assert rd.draw_stat_images.launches == n + per_call
            want = ref(*args("cpu", t))
            for k, v in got._asdict().items():
                if v is not None:
                    assert torch.equal(v.cpu(), getattr(want, k)), (make.__name__, t, k)


@pytest.mark.parametrize("logscale", [False, True])
def test_scope_render_dock_counts_fused_frames(cuda, logscale, monkeypatch):
    """A Dock on the card: every settled frame (a replay), every dynamic
    frame (a drag, a replay) and every skipped frame (interleave 1, the
    eager composite) makes one KR launch; its panels equal those of a card
    Dock whose renders take the plain chain, and a CPU Dock's."""
    from obs_color_monitor_tpu_torch.models import Dock
    from obs_color_monitor_tpu_torch.ops import render as rd
    from obs_color_monitor_tpu_torch.pipeline import profiler

    rng = np.random.default_rng(41)
    planes = [rng.integers(0, 256, (72, 96), dtype=np.uint8) for _ in range(8)]

    def run(dock, frames, mouse=None):
        out = []
        for k, b in enumerate(frames):
            if mouse is not None:
                mouse(dock, k)
            dock.push_nv12(b[:48], b[48:])
            out.append(dock.render_async().cpu().numpy())
        return out

    def plain_chain(jobs):
        return [rd.draw_stat_plain(j) for j in jobs]

    for interleave, drag in ((0, False), (1, False), (0, True)):
        rect = dict(x0=8, y0=4, x1=32, y1=16) if drag else {}
        # each Dock its own configs: a drag writes its rect into the ROI's
        docks = {name: Dock(DockConfig(), roi=cfg.ROIConfig(interleave=interleave, target_scale=2,
                                                            **rect),
                            histogram=cfg.HistogramConfig(logscale=logscale), device=d)
                 for name, d in ((cuda, cuda), ("plain", cuda), ("cpu", "cpu"))}
        plain_chain.launches = 0  # the captures read and restore it
        mouse = None
        for name, d in docks.items():
            with monkeypatch.context() as mp:
                if name == "plain":
                    mp.setattr(rd, "draw_stat_images", plain_chain)
                run(d, planes[:2])
        if drag:
            x0, y0, w, h, _, _ = docks[cuda]._rects["roi"]
            x, y = x0 + w // 2, y0 + h // 2
            for d in docks.values():
                d.mouse_move(x, y)
                d.mouse_down(x, y)
            mouse = lambda d, k: d.mouse_move(x + 2 * (k + 1), y + k + 1)
        n = rd.draw_stat_images.launches
        profiler.reset()
        profiler.enable(True)
        try:
            got = run(docks[cuda], planes[2:], mouse)
            torch.cuda.synchronize()
            snap = profiler.snapshot()
        finally:
            profiler.enable(False)
            profiler.reset()
        assert rd.draw_stat_images.launches - n == len(planes) - 2
        routes = [s["name"] for s in snap["spans"] if s["name"] in ("dock.settled", "dock.dynamic")]
        if drag:
            assert routes.count("dock.dynamic") == len(planes) - 2
        elif interleave:
            assert snap["counters"].get("dock.skipped") == (len(planes) - 2) // 2
        else:
            assert routes.count("dock.settled") == len(planes) - 2
        with monkeypatch.context() as mp:
            mp.setattr(rd, "draw_stat_images", plain_chain)
            want = run(docks["plain"], planes[2:], mouse)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        for a, b in zip(got, run(docks["cpu"], planes[2:], mouse)):
            assert np.array_equal(a, b)
