"""The port's ``make_batched_step`` on the CPU against JAX's
``make_batched_step(mesh=None)`` (a ``vmap`` of the full step), every field
exact, in the rgba, packed and NV12 formats and one P010 case, each frame
with its own zebra clock; frame b against the port's full step on frame b;
B = 1 against the full step; and the batched plain versions of K1, K2, K4
and K5 against their single-frame plain versions applied per frame.

The rendered histogram is held to the golden render of the same counts;
JAX's may differ from both only where the fill test ``count >= (1 - (row +
0.5) / 200) * hi_max`` is a tie in exact arithmetic, whose float32
roundings in golden and in XLA's CPU render fall on different sides
(``tests/test_torch_dynamic_roi.py::test_histogram_tie_follows_golden``);
with AUTO levels a count can tie when ``hi_max`` is a multiple of 16."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu.api import make_batched_step as jax_make_batched_step
from obs_color_monitor_tpu_torch import (
    Components, HistogramConfig, frame_from_numpy, golden, make_batched_step, make_full_step)
from obs_color_monitor_tpu_torch.golden import render as golden_render
from obs_color_monitor_tpu_torch.ops import convert as cv
from obs_color_monitor_tpu_torch.ops import decode as dec
from obs_color_monitor_tpu_torch.ops import pipeline as tp
from obs_color_monitor_tpu_torch.ops import scope_stats as ss

torch.set_num_threads(1)

TMS = (0.0, 1.5, 4.25)
B = len(TMS)
# (h, w, scale, format); "p010" is the nv12 format with 10-bit MSB-aligned
# u16 planes and nv12_shift=8
CASES = [(32, 48, 1, "rgba"), (32, 48, 1, "packed"), (32, 48, 1, "nv12"),
         (32, 48, 2, "rgba"), (32, 48, 2, "packed"), (32, 48, 2, "nv12"),
         (13, 17, 1, "rgba"), (13, 17, 1, "packed"), (32, 48, 1, "p010")]


def _frames(h, w, fmt, seed, n=B):
    """n host frames in ``fmt`` (a list of arrays, or of (y, uv) pairs),
    bright in their top rows so the zebra shows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if fmt in ("nv12", "p010"):
            y = rng.integers(0, 256, (h, w)).astype(np.uint8)
            y[: h // 3] = np.maximum(y[: h // 3], 220)
            uv = rng.integers(0, 256, (h // 2, w)).astype(np.uint8)
            if fmt == "p010":
                y, uv = (y.astype(np.uint16) << 8) | 0x80, (uv.astype(np.uint16) << 8) | 0x40
            out.append((y, uv))
            continue
        f = rng.integers(0, 256, (h, w, 4), np.uint8)
        f[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
        f[: h // 3, :, :3] = np.maximum(f[: h // 3, :, :3], 215)
        out.append(f.view(np.uint32)[..., 0] if fmt == "packed" else f)
    return out


def _stacked(frames, fmt):
    if fmt in ("nv12", "p010"):
        return tuple(np.stack([f[i] for f in frames]) for i in range(2))
    return np.stack(frames)


def _kw(scale, fmt):
    kw = dict(scale=scale, input_format="nv12" if fmt == "p010" else fmt)
    if fmt == "p010":
        kw["nv12_shift"] = 8
    return kw


def _port_format(fmt):
    return "nv12" if fmt == "p010" else fmt


def _check_histogram(got, jax_img, hi_counts):
    """One frame's rendered histogram (the default config) equals the
    golden render of its counts, and JAX's except at exact ties."""
    cfg = HistogramConfig()
    hi = golden.histogram_hi_max(hi_counts, Components.RGB, 0, 0, 0, 0)
    levels, hi_eff = golden.histogram_levels(hi_counts, hi, Components.RGB, False)
    assert np.array_equal(got, golden_render.render_histogram(
        levels, hi_eff, cfg.level_height, int(cfg.display), 3, False))
    # a tie in exact arithmetic: count * 2H == (2H - 2 row - 1) * hi_max
    two_h = 2 * cfg.level_height
    rows = two_h - 2 * np.arange(cfg.level_height, dtype=np.int64) - 1
    tie = (hi_counts.astype(np.int64)[:, None, :] * two_h
           == rows[None, :, None] * hi.astype(np.int64)[:, None, None]).any(0)
    assert not ((got != jax_img).any(-1) & ~tie).any()


@pytest.mark.parametrize("h,w,scale,fmt", CASES)
def test_batched_step_matches_jax(h, w, scale, fmt):
    frames = _frames(h, w, fmt, h * w + scale)
    batch = _stacked(frames, fmt)
    jstep = jax_make_batched_step(h, w, **_kw(scale, fmt))
    jx = tuple(jnp.asarray(a) for a in batch) if isinstance(batch, tuple) else jnp.asarray(batch)
    ref = {k: np.asarray(v) for k, v in
           jstep(jx, jnp.asarray(TMS, jnp.float32))._asdict().items()}
    step = make_batched_step(h, w, device="cpu", **_kw(scale, fmt))
    got = step(frame_from_numpy(batch, _port_format(fmt), "cpu"),
               torch.tensor(TMS, dtype=torch.float32)).to_numpy()
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        if k == "histogram":
            for b in range(B):
                _check_histogram(got[k][b], ref[k][b], got["hi_counts"][b])
        else:
            assert np.array_equal(got[k], ref[k]), k
    # frame b is the full step's output on frame b with clock tms[b]
    single = make_full_step(h, w, device="cpu", **_kw(scale, fmt))
    for b, f in enumerate(frames):
        one = single(frame_from_numpy(f, _port_format(fmt), "cpu"), TMS[b]).to_numpy()
        for k in one:
            assert np.array_equal(got[k][b], one[k]), (b, k)


@pytest.mark.parametrize("fmt", ["rgba", "nv12"])
def test_batch_of_one_equals_the_full_step(fmt):
    (f,) = _frames(32, 48, fmt, 5, n=1)
    step = make_batched_step(32, 48, device="cpu", input_format=fmt)
    got = step(frame_from_numpy(_stacked([f], fmt), fmt, "cpu"),
               torch.tensor([2.5], dtype=torch.float32)).to_numpy()
    want = make_full_step(32, 48, device="cpu", input_format=fmt)(
        frame_from_numpy(f, fmt, "cpu"), 2.5).to_numpy()
    for k, v in want.items():
        assert got[k].shape == (1, *v.shape) and np.array_equal(got[k][0], v), k


def test_batched_user_lut_false_colour():
    """With a user LUT the false colour is the glue's, per frame: frame b
    equals the full step's."""
    from obs_color_monitor_tpu_torch import FalseColorConfig

    lut = np.random.default_rng(3).integers(0, 256, (64, 4), np.uint8)
    kw = dict(input_format="rgba", falsecolor=FalseColorConfig(use_lut=True, lut=lut))
    frames = _frames(32, 48, "rgba", 6, n=2)
    got = make_batched_step(32, 48, device="cpu", **kw)(
        frame_from_numpy(_stacked(frames, "rgba"), "rgba", "cpu"),
        torch.tensor(TMS[:2], dtype=torch.float32)).to_numpy()
    single = make_full_step(32, 48, device="cpu", **kw)
    for b, f in enumerate(frames):
        one = single(frame_from_numpy(f, "rgba", "cpu"), TMS[b]).to_numpy()
        for k in one:
            assert np.array_equal(got[k][b], one[k]), (b, k)


def test_mesh_names_the_roadmap_item():
    # The name dates from when make_batched_step(mesh=) was refused with its
    # ROADMAP item; it no longer describes the test.  The test now checks
    # that a mesh builds the step on the mesh's device, equal to the step
    # without one (tests/test_torch_parallel.py holds it to JAX's sharded
    # step on 1, 2 and 4 ranks), and that a device of another type raises.
    import torch.distributed as dist

    from obs_color_monitor_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    try:
        with pytest.raises(ValueError):
            make_batched_step(32, 48, mesh=mesh, device="cuda")
        frames = _frames(32, 48, "rgba", 8, n=2)
        x = frame_from_numpy(_stacked(frames, "rgba"), "rgba", "cpu")
        tms = torch.tensor(TMS[:2], dtype=torch.float32)
        got = make_batched_step(32, 48, mesh=mesh)(x, tms).to_numpy()
        want = make_batched_step(32, 48, device="cpu")(x, tms).to_numpy()
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    finally:
        dist.destroy_process_group()


def test_batched_step_argument_checks():
    step = make_batched_step(32, 48, device="cpu", input_format="packed")
    frames = torch.zeros((2, 32, 48), dtype=torch.int32)
    with pytest.raises(ValueError):
        step(frames, torch.zeros(3, dtype=torch.float32))  # one clock per frame
    with pytest.raises(ValueError):
        step(frames[0], torch.zeros(1, dtype=torch.float32))  # no batch axis
    with pytest.raises(ValueError):
        step(torch.zeros((2, 32, 47), dtype=torch.int32), torch.zeros(2, dtype=torch.float32))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("h,w,scale", [(13, 17, 1), (65, 144, 2), (32, 48, 3)])
def test_batched_plain_versions_are_per_frame(h, w, scale, packed):
    """K1's and K2's plain versions take a batch frame by frame (frame b
    with tm[b]), with a leading B on every output."""
    frames = _frames(h, w, "packed" if packed else "rgba", h + w + scale)
    arr = np.stack([f if packed else np.moveaxis(f, -1, 0) for f in frames])
    x = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32) if packed
                         else np.ascontiguousarray(arr))
    tms = torch.tensor(TMS, dtype=torch.float32)
    kw = dict(packed=packed, cs=2, scale=scale)
    got = tp.frame_pass(x, tms, **kw)
    for b in range(B):
        for a, want in zip(got, tp.frame_pass_reference(x[b], TMS[b], **kw)):
            assert torch.equal(a[b], want), b
    for yuv in (False, True):
        inputs = tp.stats_inputs(got[0], got[1], yuv)
        counts = ss.vs_wv_counts(*inputs)
        for b in range(B):
            one = ss.vs_wv_counts(*(None if t is None else t[b] for t in inputs))
            for a, want in zip(counts, one):
                assert torch.equal(a[b], want), (b, yuv)


def test_batched_nv12_plain_versions_are_per_frame():
    pairs = _frames(32, 48, "nv12", 9)
    y, uv = (torch.from_numpy(a) for a in _stacked(pairs, "nv12"))
    got = dec.nv12_decode(y, uv, cs=1)
    p10 = _frames(32, 48, "p010", 10)
    y16, uv16 = (torch.from_numpy(a) for a in _stacked(p10, "p010"))
    got16 = dec.nv12_16_decode(y16, uv16, cs=2, shift=8)
    assert got.shape == got16.shape == (B, 32, 48)
    for b in range(B):
        assert torch.equal(got[b], cv.nv12_packed_reference(y[b], uv[b], 1))
        assert torch.equal(got16[b], cv.nv12_16_packed_reference(y16[b], uv16[b], 2, 8))
    with pytest.raises(ValueError):
        cv.check_nv12(y, uv[:2])
