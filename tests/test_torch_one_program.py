"""The one-program property of the port's steps, on the CPU.

On a card each step is captured once as a CUDA graph and replayed
(``graphs.CapturedStep``), which is right only if every call dispatches the
same operations on tensors of the same shapes and reads nothing back to the
host.  Here the uncaptured steps are logged: the full step (packed and
NV12), the dock step (static and dynamic) and the batched step dispatch the
same operations at the same shapes across frames, ``tm`` values and rects
from the second call on, and after the first call no
``_local_scalar_dense`` (``.item()``) and no ``lift_fresh`` (the op behind
``torch.tensor(host data)``).  Also: the zebra clock as a float and as a
0-d tensor, against JAX at two clocks; the package's top level against the
JAX package's; a logscale histogram against JAX."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import obs_color_monitor_tpu
from obs_color_monitor_tpu.api import make_full_step as jax_make_full_step
from obs_color_monitor_tpu.config import HistogramConfig as JaxHistogramConfig
from obs_color_monitor_tpu.config import LevelMode as JaxLevelMode
import obs_color_monitor_tpu_torch as ocm
from obs_color_monitor_tpu_torch import (
    DockConfig, HistogramConfig, frame_from_numpy, make_batched_step, make_dock_step,
    make_full_step)
from obs_color_monitor_tpu_torch.config import ROIConfig, from_reference

torch.set_num_threads(1)

H, W = 32, 48
HOST_READS = ("_local_scalar_dense", "lift_fresh")


class _OpLog(TorchDispatchMode):
    """Every operation a step dispatches, with its output shapes (the op log
    of ``tests/test_torch_dynamic_roi.py``)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = tuple(tuple(o.shape) for o in (out if isinstance(out, (tuple, list)) else [out])
                       if isinstance(o, torch.Tensor))
        self.ops.append((str(func), shapes))
        return out


def _rgba(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
    f[: h // 3, :, :3] = np.maximum(f[: h // 3, :, :3], 215)  # the zebra's window
    return f


def _nv12(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), np.uint8), rng.integers(0, 256, (h // 2, w), np.uint8))


RECTS = [(3, 2, 20, 12), (0, 0, 24, 16), (5, 5, 6, 6), (-4, 1, 40, 30), (10, 10, 10, 14)]
TMS = [0.0, 1.0, 2.5, 4.0, 5.75]


def _calls(kind):
    """(step, [the argument tuple of each call]) for one step kind: a new
    frame, tm and (dynamic step) rect on every call."""
    dock = DockConfig(show_focuspeaking=True)
    if kind == "full packed":
        step = make_full_step(H, W, input_format="packed", device="cpu")
        frames = [frame_from_numpy(_rgba(s).view(np.uint32)[..., 0], "packed", "cpu")
                  for s in range(5)]
    elif kind == "full nv12":
        step = make_full_step(H, W, input_format="nv12", device="cpu")
        frames = [frame_from_numpy(_nv12(s), "nv12", "cpu") for s in range(5)]
    elif kind == "dock":
        step = make_dock_step(H, W, out_width=64, out_height=400, dock=dock, device="cpu")
        frames = [frame_from_numpy(_rgba(s), "rgba", "cpu") for s in range(5)]
    elif kind == "dock nv12 dynamic":
        step = make_dock_step(H, W, out_width=64, out_height=400, dock=dock, dynamic_roi=True,
                              input_format="nv12", device="cpu")
        frames = [frame_from_numpy(_nv12(s), "nv12", "cpu") for s in range(5)]
        return step, [(f, tm, torch.tensor(r, dtype=torch.int32))
                      for f, tm, r in zip(frames, TMS, RECTS)]
    else:
        step = make_batched_step(H, W, input_format="rgba", device="cpu")
        frames = [torch.from_numpy(np.stack([_rgba(10 * s + b) for b in range(3)]))
                  for s in range(5)]
        return step, [(f, torch.tensor([tm, tm + 1.5, tm + 3.0], dtype=torch.float32))
                      for f, tm in zip(frames, TMS)]
    return step, list(zip(frames, TMS))


@pytest.mark.parametrize("kind", ["full packed", "full nv12", "dock", "dock nv12 dynamic",
                                  "batched"])
def test_steps_dispatch_the_same_operations(kind):
    step, calls = _calls(kind)
    logs = []
    for args in calls:
        with _OpLog() as log:
            step(*args)
        logs.append(log.ops)
    # the first call also builds constants cached for later calls
    assert all(ops == logs[1] for ops in logs[2:]), kind
    later = [op for ops in logs[1:] for op, _ in ops]
    assert not [op for op in later if any(r in op for r in HOST_READS)], kind
    assert not any("_local_scalar_dense" in op for op, _ in logs[0]), kind


def test_captured_step_on_the_cpu():
    """On the CPU a builder's step calls its function directly (``eager``),
    holds no graph and keeps the layout attributes; the captured dynamic
    step also takes the rect as host ints."""
    step = make_dock_step(H, W, out_width=64, out_height=400, dynamic_roi=True, device="cpu")
    assert step.graphs == 0 and callable(step.eager)
    assert set(step.rects) >= {"roi", "vectorscope"} and set(step.dims) >= set(step.rects)
    f = frame_from_numpy(_rgba(3), "rgba", "cpu")
    a = step(f, 1.5, (3, 2, 20, 12)).to_numpy()
    b = step.eager(f, 1.5, torch.tensor((3, 2, 20, 12), dtype=torch.int32)).to_numpy()
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


_JAX = {}


def _jax_full(tm):
    if "step" not in _JAX:
        _JAX["step"] = jax_make_full_step(H, W, input_format="rgba")
    out = _JAX["step"](jnp.asarray(_rgba(7)), jnp.float32(tm))
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def test_tm_as_float_or_tensor():
    """A float clock and a 0-d float32 tensor give the same outputs, the
    zebra moves between tm = 0 and tm = 1, and both equal JAX's."""
    step = make_full_step(H, W, input_format="rgba", device="cpu")
    f = frame_from_numpy(_rgba(7), "rgba", "cpu")
    zebras = []
    for tm in (0.0, 1.0):
        a = step(f, tm).to_numpy()
        b = step(f, torch.tensor(tm, dtype=torch.float32)).to_numpy()
        ref = _jax_full(tm)
        for k in ref:
            assert np.array_equal(a[k], b[k]) and np.array_equal(a[k], ref[k]), (tm, k)
        zebras.append(a["zebra"])
    assert not np.array_equal(*zebras)
    dock = make_dock_step(H, W, out_width=64, out_height=400, device="cpu")
    assert np.array_equal(dock(f, 2.5).panel.numpy(),
                          dock(f, torch.tensor(2.5, dtype=torch.float32)).panel.numpy())
    with pytest.raises(ValueError):
        step(f, torch.tensor(1.0, dtype=torch.float64))


def test_top_level_has_every_name_of_the_jax_package():
    missing = set(obs_color_monitor_tpu.__all__) - set(ocm.__all__)
    assert not missing
    assert ocm.ROIConfig is ROIConfig
    assert {"make_batched_step", "ROIConfig"} <= set(ocm.__all__)


@pytest.mark.parametrize("level_mode", [JaxLevelMode.AUTO, JaxLevelMode.RATIO])
def test_full_step_logscale_matches_jax(level_mode):
    """A logscale histogram (float32 log levels) through the full step: every
    field equal to JAX's."""
    h, w = 64, 96
    cfg = JaxHistogramConfig(logscale=True, level_mode=level_mode)
    f = _rgba(11, h, w)
    ref = jax_make_full_step(h, w, scale=2, histogram=cfg)(jnp.asarray(f), jnp.float32(0.5))
    got = make_full_step(h, w, scale=2, histogram=from_reference(cfg), device="cpu")(
        frame_from_numpy(f, "rgba", "cpu"), 0.5).to_numpy()
    assert isinstance(from_reference(cfg), HistogramConfig)
    for k, v in ref._asdict().items():
        assert np.array_equal(got[k], np.asarray(v)), k
