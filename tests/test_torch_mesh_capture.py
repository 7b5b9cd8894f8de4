"""The mesh paths' device steps (``parallel/mesh._mesh_step``) on the CPU, at
one gloo rank in this process.

On a card each of ``batch_analyze``, ``spatial_analyze`` and
``spatial_pipeline`` is one captured step, cached per (path, process group,
static arguments) and replayed as one CUDA graph, its all-reduce and halo
inside.  Here the steps run uncaptured:

* each step dispatches the same operations at the same shapes from its
  second call on, with no host read (``_local_scalar_dense``,
  ``lift_fresh``) and its collective in every call (the op log of
  ``tests/_torch_mesh_worker.py``, which runs it at 2 and 4 ranks too);
* one step per static signature: a call with other static arguments gets
  its own, a call that differs only in its frame or clock reuses it, and
  the steps of a destroyed group go with it;
* a step's output equals its ``.eager`` body's and the public function's.
The group is destroyed when the module ends (other files run in the same
worker)."""

import gc
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from obs_color_monitor_tpu_torch import parallel as par
from obs_color_monitor_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("_torch_mesh_worker", TESTS / "_torch_mesh_worker.py")
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)


@pytest.fixture(scope="module")
def meshes():
    """(batch mesh, rows mesh) over a world-size-1 gloo group, destroyed at
    the end of the module."""
    assert not dist.is_initialized()
    mb = par.make_mesh(device="cpu")
    mr = par.make_mesh(axis=par.SPATIAL_AXIS, device="cpu")
    yield mb, mr
    dist.destroy_process_group()


@pytest.mark.parametrize("path", worker.STEP_PATHS)
def test_mesh_steps_dispatch_the_same_operations(meshes, path):
    logs = worker.log_ops(worker.step_calls(*meshes)[path])
    assert worker.program_flags(path, logs) == [1, 1, 1], path
    assert not any("_local_scalar_dense" in op for op, _ in logs[0]), path


def _frame(seed, h=worker.H, w=worker.W):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[::8, :, :3] = 255
    return f


def test_steps_cached_per_static_arguments(meshes):
    mb, mr = meshes
    group = mr.get_group()
    assert mb.get_group() is group  # one group, one cache for both meshes
    a = pm._mesh_step("spatial_pipeline", mr, cs=2)
    # the defaults filled in are the same signature
    assert pm._mesh_step("spatial_pipeline", mr, cs=2, th_low=0.75, zb_cs=2, fc_cs=2,
                         peak_th=3062, peak_rgba=[255, 0, 0, 255]) is a
    others = [pm._mesh_step("spatial_pipeline", mr, cs=2, peak_th=100),
              pm._mesh_step("spatial_pipeline", mr, cs=2, zb_cs=1),
              pm._mesh_step("spatial_pipeline", mr, cs=2, components="yuv"),
              pm._mesh_step("spatial_pipeline", mr, cs=1),
              pm._mesh_step("spatial_analyze", mr, cs=2),
              pm._mesh_step("batch_analyze", mb, cs=2)]
    assert len({id(s) for s in [a, *others]}) == 7
    held = len(pm._STEPS[group])
    # public calls that differ in frame and clock only reuse the step
    for seed, tm in ((1, 0.5), (2, 3.25)):
        out = par.spatial_pipeline(_frame(seed), mr, cs=2, tm=tm)
        want = a.eager(torch.from_numpy(_frame(seed)), tm)
        assert all(torch.equal(g, w) for g, w in zip(out, want))
    par.spatial_analyze(_frame(3), mr, cs=2)
    par.batch_analyze(np.stack([_frame(4), _frame(5)]), mb, cs=2)
    assert len(pm._STEPS[group]) == held
    par.batch_analyze(np.stack([_frame(4), _frame(5)]), mb, cs=1)
    assert len(pm._STEPS[group]) == held + 1
    with pytest.raises(ValueError):
        pm._mesh_step("batch_analyze", mb, cs=2, components="rgba")


def test_steps_of_a_destroyed_group_go_with_it(meshes):
    """A step holds its group weakly: destroying a group frees its steps
    (on a card, their graphs and memory pools)."""
    from torch.distributed.device_mesh import DeviceMesh

    sub = dist.new_group([0], backend="gloo")
    mesh = DeviceMesh.from_group(sub, "cpu", mesh_dim_names=(par.SPATIAL_AXIS,))
    step = pm._mesh_step("spatial_analyze", mesh, cs=2)
    out = par.spatial_analyze(_frame(6), mesh, cs=2)
    assert torch.equal(out[0], step.eager(torch.from_numpy(_frame(6)))[0])
    assert sub in pm._STEPS
    groups = len(pm._STEPS)
    dist.destroy_process_group(sub)
    del sub, mesh, step
    gc.collect()
    assert len(pm._STEPS) == groups - 1
    assert meshes[1].get_group() in pm._STEPS
