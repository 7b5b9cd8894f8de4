"""The port's counterparts of the JAX package's four Pallas modules, as the
JAX test suite calls them.

``ops/pallas_{stats,convert,overlays,pipeline}.py`` hold the TPU kernels;
the port has a hand-written CUDA kernel for each, behind the wrappers of
``ops/{decode,fused_overlays,pipeline,scope_stats}.py``.  This module maps
each public function of the Pallas modules, with JAX's signature, onto the
port's wrapper, so that ``_torch_jax_suite`` can point the JAX tests at the
port: ``obs_color_monitor_tpu.ops.pallas_stats`` becomes
``_torch_pallas_counterparts.pallas_stats``, and so on.

- Host arrays (numpy, JAX) go through the port's one conversion
  (``ops.convert._as_device_arg``), to the default device: the CPU here,
  where each wrapper runs its kernel's plain version.
- ``interpret=`` (the Pallas interpreter) and ``col_split=`` (a Mosaic
  grid split) are accepted and ignored.
- Results come back as host (numpy) arrays, which the JAX tests hand to
  ``jnp`` functions as they hand JAX's own results; a packed output is the
  uint32 view of its bytes, as JAX returns it.
- The JAX tests compare the Pallas functions with the portable (XLA)
  route's private functions in ``ops/convert.py``; :data:`XLA_TWINS` holds
  the port's plain versions under those names, which the gate sets on the
  port's ``ops.convert`` while it runs.  Those cases compare the port's
  plain version with itself on the CPU.
- ``pallas_pipeline.pipeline_fits`` (the TPU's VMEM admission) and
  ``pallas_stats.vs_swar_from_tiles`` (K2 on the Mosaic tile layout) have
  no counterpart (:data:`NO_COUNTERPART`).

| JAX function (file:line) | port counterpart |
|---|---|
| ``pallas_convert.nv12_decode_pallas`` (:134) | ``ops.decode.nv12_decode`` (K4) |
| ``pallas_convert.nv12_16_decode_pallas`` (:169) | ``ops.decode.nv12_16_decode`` (K5) |
| ``pallas_overlays.fused_overlays_planes`` (:208) | ``ops.fused_overlays.fused_overlays_planes`` (K3) |
| ``pallas_pipeline.frame_pipeline`` (:290) | ``ops.pipeline.frame_pipeline`` (K1, K2) |
| ``pallas_stats.vectorscope_pallas_i32`` (:170) | ``ops.scope_stats.vs_wv_counts``, vectorscope alone (K7) |
| ``pallas_stats.waveform_pallas_i32`` (:217) | ``ops.scope_stats.vs_wv_counts``, waveform alone (K8) |
| ``pallas_stats.fused_vs_wv_pallas_i32`` (:633) | ``ops.scope_stats.vs_wv_counts``, both (K6) |
| ``pallas_stats.histogram_from_waveform`` (:242) | ``ops.scope_stats.histogram_from_waveform`` |
| ``pallas_stats.fused_ingest_stats_scale1/2`` (:597, :614) | ``ops.pipeline.fused_ingest_stats_scale1/2`` (K9) |
"""

from __future__ import annotations

import sys
import types

import numpy as np
import torch

from obs_color_monitor_tpu_torch.ops import convert, decode, fused_overlays, pipeline, scope_stats
from obs_color_monitor_tpu_torch.ops.convert import _as_device_arg

# JAX (module, function) -> (port module, port function), for the meta-test
TABLE = {
    ("pallas_convert", "nv12_decode_pallas"): ("ops.decode", "nv12_decode"),
    ("pallas_convert", "nv12_16_decode_pallas"): ("ops.decode", "nv12_16_decode"),
    ("pallas_overlays", "fused_overlays_planes"): ("ops.fused_overlays", "fused_overlays_planes"),
    ("pallas_pipeline", "frame_pipeline"): ("ops.pipeline", "frame_pipeline"),
    ("pallas_stats", "vectorscope_pallas_i32"): ("ops.scope_stats", "vs_wv_counts"),
    ("pallas_stats", "waveform_pallas_i32"): ("ops.scope_stats", "vs_wv_counts"),
    ("pallas_stats", "fused_vs_wv_pallas_i32"): ("ops.scope_stats", "vs_wv_counts"),
    ("pallas_stats", "histogram_from_waveform"): ("ops.scope_stats", "histogram_from_waveform"),
    ("pallas_stats", "fused_ingest_stats_scale1"): ("ops.pipeline", "fused_ingest_stats_scale1"),
    ("pallas_stats", "fused_ingest_stats_scale2"): ("ops.pipeline", "fused_ingest_stats_scale2"),
}
# public functions of the Pallas modules with no counterpart, and why
NO_COUNTERPART = {
    ("pallas_pipeline", "pipeline_fits"): "the TPU's VMEM admission of a frame shape",
    ("pallas_stats", "vs_swar_from_tiles"): "K2's TPU entry on the stripe-tile layout that "
                                            "frame_pipeline builds for Mosaic; the port's K2 "
                                            "(scope_stats.vs_wv_counts) takes the planes",
}


def _t(a, device=None) -> torch.Tensor:
    return _as_device_arg(a, device)


def _host(x):
    """A result (a tensor, None, or a tuple of them) as host arrays."""
    if isinstance(x, tuple):
        return tuple(_host(o) for o in x)
    return None if x is None else x.cpu().numpy()


def _u32(t: torch.Tensor):
    return _host(t).view(np.uint32)


# --- pallas_convert ----------------------------------------------------------


def nv12_decode_pallas(y, uv, cs: int = 2, interpret: bool = False):
    y = _t(y)
    return _u32(decode.nv12_decode(y, _t(uv, y.device), cs=cs))


def nv12_16_decode_pallas(y16, uv16, cs: int = 2, shift: int = 2, interpret: bool = False):
    y16 = _t(y16)
    return _u32(decode.nv12_16_decode(y16, _t(uv16, y16.device), cs=cs, shift=shift))


# --- pallas_overlays ---------------------------------------------------------


def fused_overlays_planes(planes, tm, th_low, th_high, zb_cs, fc_cs, peak_th, peak_rgba,
                          rect=None, interpret: bool = False, packed_out: bool = False):
    planes = _t(planes)
    if rect is not None:
        rect = _t(rect, planes.device)
    if not isinstance(tm, (int, float)):
        tm = _t(tm, planes.device).to(torch.float32)
    out = fused_overlays.fused_overlays_planes(
        planes, tm, th_low=th_low, th_high=th_high, zb_cs=zb_cs, fc_cs=fc_cs,
        peak_th=peak_th, peak_rgba=peak_rgba, rect=rect, packed_out=packed_out)
    return tuple(_u32(o) for o in out) if packed_out else _host(out)


# --- pallas_pipeline ---------------------------------------------------------


def frame_pipeline(planes, tm=0.0, rect=None, *, cs: int, scale: int, yuv_data: bool = False,
                   with_overlays: bool = True, packed: bool = False, th_low: float = 0.75,
                   th_high: float = 1.0, zb_cs: int = 2, fc_cs: int = 2, peak_th: int = 3062,
                   peak_rgba=(255, 0, 0, 255), interpret: bool = False, col_split: int = 1):
    planes = _t(planes)
    if rect is not None:
        rect = _t(rect, planes.device)
    if not isinstance(tm, (int, float)):
        tm = _t(tm, planes.device).to(torch.float32)
    return _host(pipeline.frame_pipeline(
        planes, tm, rect, yuv_data=yuv_data, cs=cs, scale=scale, with_overlays=with_overlays,
        packed=packed, th_low=th_low, th_high=th_high, zb_cs=zb_cs, fc_cs=fc_cs,
        peak_th=peak_th, peak_rgba=peak_rgba))


# --- pallas_stats ------------------------------------------------------------


def vectorscope_pallas_i32(yuv_planes, interpret: bool = False):
    yuv = _t(yuv_planes)
    return _host(scope_stats.vs_wv_counts(yuv[1].contiguous(), yuv[2].contiguous(), None,
                                          None, need_wv=False)[0])


def waveform_pallas_i32(planes_in, mask, interpret: bool = False):
    data = _t(planes_in)
    return _host(scope_stats.vs_wv_counts(None, None, data, _t(mask, data.device),
                                          need_vs=False)[1])


def fused_vs_wv_pallas_i32(planes_in, yuv_planes, mask, interpret: bool = False):
    data, yuv = _t(planes_in), _t(yuv_planes)
    return _host(scope_stats.vs_wv_counts(yuv[1].contiguous(), yuv[2].contiguous(), data,
                                          _t(mask, data.device)))


def histogram_from_waveform(wv_i32):
    return _host(scope_stats.histogram_from_waveform(_t(wv_i32)))


def fused_ingest_stats_scale1(planes, cs: int, yuv_data: bool = False, interpret: bool = False):
    return _host(pipeline.fused_ingest_stats_scale1(_t(planes), cs, yuv_data))


def fused_ingest_stats_scale2(planes, cs: int, yuv_data: bool = False, interpret: bool = False):
    return _host(pipeline.fused_ingest_stats_scale2(_t(planes), cs, yuv_data))


# --- the portable route's private functions in ops/convert.py -----------------


def _nv12_to_packed_xla(y, uv, cs: int = 2):
    y = _t(y)
    return _u32(convert.nv12_packed_reference(y, _t(uv, y.device), cs))


def _nv12_16_to_packed_xla(y16, uv16, cs: int = 2, shift: int = 2):
    y16 = _t(y16)
    return _u32(convert.nv12_16_packed_reference(y16, _t(uv16, y16.device), cs, shift))


def _nv12_pallas_ok(y, uv, lanes: int = 4) -> bool:
    """Whether ``nv12_to_packed`` takes the kernel route: in the port, a
    pair of CUDA tensors (the route follows the planes' device)."""
    return isinstance(y, torch.Tensor) and y.device.type == "cuda"


# name in ops/convert.py -> the port's plain version under that name
XLA_TWINS = {f.__name__: f for f in (_nv12_to_packed_xla, _nv12_16_to_packed_xla,
                                     _nv12_pallas_ok)}


def _submodule(name: str) -> types.ModuleType:
    """``_torch_pallas_counterparts.<name>``: the counterparts of the JAX
    module ``ops.<name>``, importable under that dotted name."""
    mod = types.ModuleType(f"{__name__}.{name}", f"counterparts of ops.{name}")
    for (jmod, fn) in TABLE:
        if jmod == name:
            setattr(mod, fn, globals()[fn])
    sys.modules[mod.__name__] = mod
    return mod


__path__: list[str] = []  # a package, so that ``import <this>.pallas_stats`` resolves
pallas_convert = _submodule("pallas_convert")
pallas_overlays = _submodule("pallas_overlays")
pallas_pipeline = _submodule("pallas_pipeline")
pallas_stats = _submodule("pallas_stats")
