"""The JAX package's own calls of ``ops.fused.analyze``,
``ops.graticule.falsecolor_key_overlay`` and ``ops.fused.default_backend``,
run unchanged through the port on the CPU, each result equal to JAX's bit
for bit: the odd-shape fuzz call (``tests/test_fuzz.py:33-40``) and the
fused YUV combination (``:128-130``) with ``backend="xla"``, the packed view
against the planar frame (``tests/test_dock_layout.py:398-405``), and the
keywords around them: ``keep_rgba=False`` (``planes`` None in both
packages), ``tm`` (no result changes, and no host read), the routes that
``backend`` refuses.  The key legend positionally as ``(..., cs, lut_key,
lut)`` and by keyword, with and without a LUT."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from obs_color_monitor_tpu.config import ShowKey as JaxShowKey
from obs_color_monitor_tpu.ops import fused as jfused
from obs_color_monitor_tpu.ops import graticule as jgrat
from obs_color_monitor_tpu_torch.config import CaptureConfig, ShowKey
from obs_color_monitor_tpu_torch.models import Vectorscope
from obs_color_monitor_tpu_torch.ops import fused as tfused
from obs_color_monitor_tpu_torch.ops import graticule as tgrat
from test_torch_one_program import HOST_READS, _OpLog

torch.set_num_threads(1)

FIELDS = ("yuv_planes", "vs_counts", "wv_rgb", "wv_yuv", "hi_rgb", "hi_yuv", "planes")
FUZZ_SHAPES = [(1, 1), (7, 3), (8, 128), (31, 257), (130, 96), (257, 129)]


def _fuzz_frame(h, w, seed=0):
    """``tests/test_fuzz.py:30-32``: random RGBA, a fifth of it alpha 0."""
    rng = np.random.default_rng(seed + 1000 * h + w)
    f = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.2, 0, 255)
    return f


def _equal(got, want):
    for name in FIELDS:
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a, b = np.asarray(a), b.cpu().numpy()
            assert a.shape == b.shape, (name, a.shape, b.shape)
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


@pytest.mark.parametrize("shape", FUZZ_SHAPES)
def test_fuzz_call_equals_jax(shape):
    f = _fuzz_frame(*shape)
    call = dict(cs=1, need_vs=True, need_wv_rgb=True, need_hi_rgb=True, backend="xla")
    _equal(tfused.analyze(f, **call), jfused.analyze(f, **call))


def test_fused_combo_yuv_call_equals_jax():
    f = _fuzz_frame(64, 96)
    f[..., 3] = 255
    call = dict(cs=1, need_vs=True, need_wv_yuv=True, need_hi_yuv=True, backend="xla")
    _equal(tfused.analyze(f, **call), jfused.analyze(f, **call))


def _dock_layout_inputs():
    """``tests/test_dock_layout.py:394-401``: the planar frame and its u32
    packed view."""
    frame = np.random.default_rng(5).integers(0, 256, (70, 150, 4), np.uint8)
    planes = np.ascontiguousarray(np.moveaxis(frame, -1, 0))
    x32 = np.ascontiguousarray(frame).view(np.uint32)[..., 0]
    return planes, x32


@pytest.mark.parametrize("keep_rgba", [True, False])
def test_packed_equals_planar_as_in_jax(keep_rgba):
    planes, x32 = _dock_layout_inputs()
    kw = dict(cs=2, scale=2, need_vs=True, need_wv_rgb=True, need_hi_rgb=True,
              keep_rgba=keep_rgba)
    want_a = jfused.analyze(jnp.asarray(planes), is_planar=True, **kw)
    want_b = jfused.analyze(jnp.asarray(x32), is_packed=True, **kw)
    got_a = tfused.analyze(planes, is_planar=True, **kw)
    got_b = tfused.analyze(torch.from_numpy(x32), is_packed=True, **kw)
    for got, want in ((got_a, want_a), (got_b, want_b), (got_b, want_a)):
        _equal(got, want)
    assert (got_b.planes is None) == (not keep_rgba)


@pytest.mark.parametrize("fmt", ["rgba", "packed", "planar"])
@pytest.mark.parametrize("needs", [
    dict(need_vs=True, need_wv_rgb=True, need_hi_yuv=True),  # K6: both counts
    dict(need_vs=True),  # K7: the vectorscope alone
    dict(need_wv_yuv=True, need_hi_rgb=True),  # K8: the waveforms alone
])
def test_keywords_change_nothing_but_planes(fmt, needs):
    """``keep_rgba``, ``tm`` (a float or a 0-d tensor) and ``backend="xla"``
    on a CPU tensor: every field equal to the default call's and to JAX's,
    ``planes`` None without ``keep_rgba``."""
    f = _fuzz_frame(38, 54, len(needs))
    x = {"rgba": f, "packed": f.view(np.uint32)[..., 0],
         "planar": np.ascontiguousarray(np.moveaxis(f, -1, 0))}[fmt]
    kw = dict(cs=2, scale=2, is_planar=fmt == "planar", **needs)
    base = tfused.analyze(torch.from_numpy(x), **kw)
    want = jfused.analyze(jnp.asarray(x), is_packed=fmt == "packed", tm=1.5, backend="xla", **kw)
    _equal(base, want)
    for extra in (dict(keep_rgba=True), dict(tm=0.0), dict(tm=4.0),
                  dict(tm=torch.tensor(4.0)), dict(tm=torch.tensor(0.0)),
                  dict(backend="xla"), dict(is_packed=fmt == "packed")):
        _equal(tfused.analyze(torch.from_numpy(x), **kw, **extra), base)
    bare = tfused.analyze(torch.from_numpy(x), keep_rgba=False, tm=4.0, **kw)
    jbare = jfused.analyze(jnp.asarray(x), is_packed=fmt == "packed", keep_rgba=False,
                           tm=jnp.float32(4.0), **kw)
    assert bare.planes is None and jbare.planes is None
    _equal(bare, jbare)
    _equal(bare, base._replace(planes=None))


def test_tm_tensor_is_not_read_on_the_host():
    """No ``.item()`` (``_local_scalar_dense``) and no tensor made from host
    data (``lift_fresh``): what a captured step needs."""
    f = torch.from_numpy(_fuzz_frame(32, 48))
    tm = torch.tensor(3.0)
    with _OpLog() as log:
        tfused.analyze(f, cs=2, scale=2, need_vs=True, need_wv_rgb=True, tm=tm)
    assert log.ops and not [op for op, _ in log.ops if any(r in op for r in HOST_READS)]


@pytest.mark.parametrize("kw,match", [
    (dict(backend="pallas"), "cpu"),  # the kernels need a CUDA tensor
    (dict(backend="mosaic"), "cpu"),
    (dict(is_packed=True), "packed"),  # an (H, W, 4) frame is not the packed view
    (dict(tm=torch.zeros(2)), "tm"),
])
def test_refused_keywords_raise(kw, match):
    f = torch.from_numpy(_fuzz_frame(8, 16))
    with pytest.raises(ValueError, match=match):
        tfused.analyze(f, cs=2, need_vs=True, **kw)


def test_packed_and_planar_together_raise():
    planes, x32 = _dock_layout_inputs()
    with pytest.raises(ValueError, match="is_planar"):
        tfused.analyze(torch.from_numpy(x32), cs=2, is_packed=True, is_planar=True)


def test_default_backend_names_the_cpu_route():
    assert tfused.default_backend() == "xla" == jfused.default_backend()


@pytest.mark.parametrize("cuda_available,backend,device", [
    (True, None, "cuda"), (True, "pallas", "cuda"), (True, "xla", "cpu"),
    (False, None, "cpu"), (False, "pallas", "cuda"), (False, "xla", "cpu"),
])
def test_host_array_goes_to_the_route_device(monkeypatch, cuda_available, backend, device):
    """A host array lands on the device of the route ``backend`` names, and
    without it on the default device: the card wherever there is one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda_available)
    assert tfused._host_array_device(backend) == device


def test_host_array_with_xla_runs_on_the_cpu():
    f = _fuzz_frame(16, 24)
    res = tfused.analyze(f, cs=2, need_vs=True, need_wv_rgb=True, backend="xla")
    assert res.planes.device.type == res.vs_counts.device.type == "cpu"


LUT = np.random.default_rng(3).integers(0, 256, (7, 4), np.uint8)


@pytest.mark.parametrize("show_key", [int(k) for k in ShowKey])
@pytest.mark.parametrize("lut", [None, LUT], ids=["bands", "lut"])
@pytest.mark.parametrize("cs", [1, 2])
def test_falsecolor_key_overlay_positional_and_keywords(show_key, lut, cs):
    lut_key = None if lut is None else ("k",)
    want = jgrat.falsecolor_key_overlay(JaxShowKey(show_key), 96, 54, cs, lut_key, lut)
    for got in (
            tgrat.falsecolor_key_overlay(ShowKey(show_key), 96, 54, cs, lut_key, lut),
            tgrat.falsecolor_key_overlay(ShowKey(show_key), 96, 54, cs, lut_key=lut_key,
                                         lut=lut),
            tgrat.falsecolor_key_overlay(show_key, 96, 54, cs, lut=lut)):
        assert (got is None) == (want is None)
        if want is not None:
            assert got.shape == want.shape and np.array_equal(got, want)


def test_attach_private_hub_keeps_the_scope_device():
    sc = Vectorscope(device="cpu")
    hub = sc.attach_private_hub(CaptureConfig(target_scale=2))
    assert hub.device == torch.device("cpu") and sc._hub is hub
