"""The hand-written kernels against their plain versions on a CUDA card.

Marked ``cuda``; each test skips when no card is present (decided inside a
fixture, never at import).  Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu_torch import frame_from_numpy, make_full_step
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
