"""The hand-written kernels against their plain versions on a CUDA card.

Marked ``cuda``; each test skips when no card is present (decided inside a
fixture, never at import).  Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu_torch import DockConfig, frame_from_numpy, make_dock_step, make_full_step
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
