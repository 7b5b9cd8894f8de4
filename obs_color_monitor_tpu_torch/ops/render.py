"""Scope renderers: counts -> RGBA images, on torch tensors.

Counterpart of ``obs_color_monitor_tpu/ops/render.py`` (the draw shaders
``data/vectorscope.effect``, ``data/waveform.effect``,
``data/histogram.effect``).  Tints are Q12 integers and the histogram fill
test is one float32 multiply, so the images are the same on every device.
In YUV mode display channel i reads count channel ``DISP_YUV[i]`` (the
reference's BGRA staging order); the spec is ``golden/render.py``.  A host
array-like input goes to the default device (``convert._as_device_arg``).

:func:`draw_stat_images` draws the three stats scopes' images from their
counts, graticule and zoom included, as one table of jobs
(:class:`StatJob`): one launch of kernel KR (``csrc/scope_render.cu``) on a
card, the torch chain of the functions here (its plain version) on the
CPU.  Both routes of the dock and each stats scope draw through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import _kernels
from ..colorspace import VECTORSCOPE_TINT, Colorspace
from ..config import DisplayMode
from ..golden import render as golden_render
from .convert import OPAQUE_BLACK, _as_device_arg
from .stats import apply_channel_select, histogram_hi_max, histogram_levels

DISP_RGB, DISP_YUV = golden_render.DISP_RGB, golden_render.DISP_YUV
TINT_Q12, TINT_U8 = golden_render.TINT_Q12, golden_render.TINT_U8

VS_SIZE = 256


def _compose_rgba(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Three (H, W) int32 planes with values 0..255 -> (H, W, 4) u8, alpha
    255: one int32 compose, then a little-endian byte view."""
    x = r | (g << 8) | (b << 16) | OPAQUE_BLACK
    return x.contiguous().view(torch.uint8).view(*x.shape, 4)


def render_vectorscope(
    counts: torch.Tensor, intensity: int, cs: int, white: bool
) -> torch.Tensor:
    """counts (256, 256) u8 [v, u] ascending -> RGBA (256, 256, 4); row 0 is
    v = 255 (``render.render_vectorscope``).  The chroma tint
    ``(C*256 + Cu*(2u+1-256) + Cv*(256-(2v+1))) * level`` is Q20 and rounds
    with an arithmetic shift of the (possibly negative) int32."""
    counts = _as_device_arg(counts)
    v = (counts.flip(0).to(torch.int32) * int(intensity)).clamp(max=255)
    if white:
        return _compose_rgba(v, v, v)
    C, Cu, Cv = _vs_tint(int(cs))
    idx = torch.arange(VS_SIZE, dtype=torch.int32, device=counts.device)
    fu = (2 * idx + 1 - 256)[None, :]
    fv = (256 - (2 * idx + 1))[:, None]
    chans = []
    for c in range(3):
        num = int(C[c]) * 256 + int(Cu[c]) * fu + int(Cv[c]) * fv  # Q20
        chans.append(((num * v + (1 << 19)) >> 20).clamp_(0, 255))
    return _compose_rgba(*chans)


@functools.lru_cache(maxsize=8)
def _vs_tint(cs: int) -> tuple:
    """The vectorscope's Q12 chroma tint of colorspace ``cs``: C, Cu and
    Cv, three ints each (one per colour)."""
    tint = VECTORSCOPE_TINT[Colorspace(cs)]
    return tuple(tuple(int(v) for v in np.round(np.asarray(t[:3]) * 4096).astype(np.int64))
                 for t in (tint["color"], tint["color_u"], tint["color_v"]))


def _disp_order(yuv_mode: bool) -> tuple[int, int, int]:
    return DISP_YUV if yuv_mode else DISP_RGB


def _reorder(x: torch.Tensor, yuv_mode: bool) -> torch.Tensor:
    """The channels of ``x`` in display order.  Stacked from the channels
    themselves: an index list would cross from the host on every call (and
    a CUDA graph cannot capture that copy)."""
    return torch.stack([x[i] for i in _disp_order(yuv_mode)])


def _bands(n_components: int) -> tuple[int, ...]:
    return (0, 1, 2) if n_components == 3 else (0, 2)


def render_waveform(
    counts: torch.Tensor,
    intensity: int,
    display: int,
    n_components: int,
    yuv_mode: bool,
) -> torch.Tensor:
    """counts (3, 256, W) u8 ascending -> RGBA image
    (``render.render_waveform``): OVERLAY maps each display channel to
    ``min(count * intensity, 255)``; STACK/PARADE tile Q12-tinted bands
    vertically/horizontally (n = 2 shows bands 0 and 2; n = 1 is OVERLAY)."""
    vals = (_reorder(_as_device_arg(counts), yuv_mode).flip(1).to(torch.int32) * int(intensity)).clamp(max=255)
    if n_components <= 1 or DisplayMode(display) == DisplayMode.OVERLAY:
        return _compose_rgba(vals[0], vals[1], vals[2])
    dim = 0 if DisplayMode(display) == DisplayMode.STACK else 1
    chans = [
        torch.cat(
            [
                ((vals[b] * int(TINT_Q12[b, c]) + 2048) >> 12).clamp_(0, 255)
                for b in _bands(n_components)
            ],
            dim=dim,
        )
        for c in range(3)
    ]
    return _compose_rgba(*chans)


def render_histogram(
    levels: torch.Tensor,
    hi_max: torch.Tensor,
    level_height: int,
    display: int,
    n_components: int,
    yuv_mode: bool,
) -> torch.Tensor:
    """levels (3, 256) f32 + hi_max (3,) f32 -> RGBA bars
    (``render.render_histogram``): a pixel is filled where
    ``level >= (1 - (row + 0.5) / H) * hi_max``, all in float32."""
    H = int(level_height)
    levels = _as_device_arg(levels)
    hi_max = _as_device_arg(hi_max, levels.device)
    lv = _reorder(levels, yuv_mode).to(torch.float32)
    hm = _reorder(hi_max, yuv_mode).to(torch.float32)
    rows = torch.arange(H, dtype=torch.float32, device=levels.device)
    # a tensor divisor: divided by a host scalar, CUDA multiplies by its
    # rounded reciprocal, which differs from the true quotient by an ulp at
    # some rows and flips the fill at exact ties (count * 2H == (2H - 2 row
    # - 1) * hi_max); the CPU divides, as golden does
    thr = (1.0 - (rows + 0.5) / torch.full_like(rows, float(H)))[:, None]  # (H, 1)
    fill = lv[:, None, :] >= thr[None] * hm[:, None, None]  # (3, H, 256)
    zero = torch.zeros((), dtype=torch.int32, device=levels.device)
    if n_components <= 1 or DisplayMode(display) == DisplayMode.OVERLAY:
        on = [torch.where(fill[c], 255, zero) for c in range(3)]
        return _compose_rgba(*on)
    dim = 0 if DisplayMode(display) == DisplayMode.STACK else 1
    chans = [
        torch.cat(
            [torch.where(fill[b], int(TINT_U8[b, c]), zero) for b in _bands(n_components)],
            dim=dim,
        )
        for c in range(3)
    ]
    return _compose_rgba(*chans)


def _blend(src: torch.Tensor, alpha: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``(s*a + d*(255-a) + 127) // 255`` in int32, back to u8."""
    a = alpha.to(torch.int32)
    return ((src.to(torch.int32) * a + dst.to(torch.int32) * (255 - a) + 127) // 255).to(
        torch.uint8
    )


def blend_overlay(image: torch.Tensor, overlay: torch.Tensor) -> torch.Tensor:
    """Integer srcalpha/invsrcalpha blend of an (H, W, 4) u8 overlay onto an
    (H, W, 4) u8 image; the image's alpha passes through
    (``render.blend_overlay``, the device twin of ``utils.draw.alpha_blend_u8``)."""
    image = _as_device_arg(image)
    overlay = _as_device_arg(overlay, image.device)
    rgb = _blend(overlay[..., :3], overlay[..., 3:4], image[..., :3])
    return torch.cat([rgb, image[..., 3:]], dim=-1)


def blend_overlay_planes(planes: torch.Tensor, overlay_planes: torch.Tensor) -> torch.Tensor:
    """Planar twin of :func:`blend_overlay`: (4, H, W) image and overlay
    (``render.blend_overlay_planes``)."""
    planes = _as_device_arg(planes)
    overlay_planes = _as_device_arg(overlay_planes, planes.device)
    rgb = _blend(overlay_planes[:3], overlay_planes[3:4], planes[:3])
    return torch.cat([rgb, planes[3:]], dim=0)


def zoom_center(image: torch.Tensor, zoom: float) -> torch.Tensor:
    """Vectorscope zoom about the centre (``render.zoom_center``): scale by
    ``zoom`` with offset 127.5 * (1 - zoom), point-sampled through a host
    index map."""
    image = _as_device_arg(image)
    if zoom <= 1.01:
        return image
    idx = _zoom_index(image.shape[0], float(zoom), image.device)
    return image.index_select(0, idx).index_select(1, idx)


@functools.lru_cache(maxsize=64)
def _zoom_index(n: int, zoom: float, device: torch.device) -> torch.Tensor:
    """The source row/column of each of ``n`` zoomed samples, on ``device``
    (built once per zoom: no host copy per frame)."""
    ofst = (n / 2 - 0.5) * (1.0 - zoom)
    src = np.clip(np.floor((np.arange(n) + 0.5 - ofst) / zoom).astype(np.int64), 0, n - 1)
    return torch.as_tensor(src, device=device)


# -- the stats scopes' images in one launch (kernel KR) ----------------------

# job kinds, as scope_render.cu numbers them
VECTORSCOPE, WAVEFORM, HISTOGRAM = range(3)
MAX_JOBS = 3  # one per stats scope
_RUN, _THREADS = 4, 256  # scope_render.cu: pixels a thread, threads a block
# the histogram's hi_max in the kernel: a host value, a 0-d pixel count in
# device memory times the permille, the counts' per-channel maximum
_HI_HOST, _HI_RATIO, _HI_AUTO = range(3)


class StatJob(NamedTuple):
    """One stats scope's image as :func:`draw_stat_images` draws it: its
    counts, its graticule and its render settings (the keywords of
    ``render_vectorscope``, ``render_waveform`` and the histogram's
    ``histogram_hi_max`` / ``histogram_levels`` / ``render_histogram``).
    Built by :func:`vectorscope_job`, :func:`waveform_job` and
    :func:`histogram_job`."""

    kind: int
    # VECTORSCOPE (256, 256) u8; WAVEFORM (3, 256, W) u8; HISTOGRAM (3, 256)
    # int32; raw, before the channel selection
    counts: torch.Tensor
    graticule: Optional[torch.Tensor]  # (h, w, 4) u8 of the image's shape, or None
    intensity: int = 1
    cs: int = 0  # VECTORSCOPE: the tint's colorspace
    white: bool = False  # VECTORSCOPE
    zoom: float = 1.0  # VECTORSCOPE: sampled about the centre above 1.01
    display: int = 0  # WAVEFORM, HISTOGRAM: a DisplayMode
    n_components: int = 3
    yuv_mode: bool = False
    sel: tuple = (True, True, True)  # the channels drawn
    level_height: int = 200  # HISTOGRAM
    level_fixed: int = 0  # HISTOGRAM: hi_max's mode, as histogram_hi_max takes it
    level_ratio_permille: int = 0
    n_pixels: Union[int, torch.Tensor] = 0  # a host int or a 0-d integer tensor
    logscale: bool = False


def vectorscope_job(counts, graticule, intensity: int, cs: int, white: bool,
                    zoom: float = 1.0) -> StatJob:
    """The vectorscope's job: ``render_vectorscope``, the graticule blended,
    then ``zoom_center``."""
    return StatJob(VECTORSCOPE, _as_device_arg(counts), graticule, int(intensity), int(cs),
                   bool(white), float(zoom))


def waveform_job(counts, graticule, sel, intensity: int, display: int, n_components: int,
                 yuv_mode: bool) -> StatJob:
    """The waveform's job: ``render_waveform`` of the selected counts, the
    graticule blended."""
    return StatJob(WAVEFORM, _as_device_arg(counts), graticule, int(intensity),
                   display=int(display), n_components=int(n_components),
                   yuv_mode=bool(yuv_mode), sel=tuple(bool(v) for v in sel))


def histogram_job(counts, graticule, sel, n_pixels, level_fixed: int, level_ratio_permille: int,
                  logscale: bool, level_height: int, display: int, n_components: int,
                  yuv_mode: bool) -> StatJob:
    """The histogram's job: the selected counts' hi_max and levels,
    ``render_histogram``, the graticule blended."""
    return StatJob(HISTOGRAM, _as_device_arg(counts), graticule, display=int(display),
                   n_components=int(n_components), yuv_mode=bool(yuv_mode),
                   sel=tuple(bool(v) for v in sel), level_height=int(level_height),
                   level_fixed=int(level_fixed),
                   level_ratio_permille=int(level_ratio_permille), n_pixels=n_pixels,
                   logscale=bool(logscale))


def _n_bands(job: StatJob) -> int:
    """The bands a STACK or PARADE image tiles; 1 where it is drawn as
    OVERLAY."""
    if job.n_components <= 1 or job.display == DisplayMode.OVERLAY:
        return 1
    return len(_bands(job.n_components))


def stat_image_shape(job: StatJob) -> tuple[int, int]:
    """(h, w) of the job's image."""
    if job.kind == VECTORSCOPE:
        return VS_SIZE, VS_SIZE
    h, w = (256, job.counts.shape[-1]) if job.kind == WAVEFORM else (job.level_height, 256)
    n = _n_bands(job)
    return (h * n, w) if job.display == DisplayMode.STACK else (h, w * n)


def draw_stat_plain(job: StatJob) -> torch.Tensor:
    """The plain version of one job: the torch chain the kernel replaces."""
    if job.kind == VECTORSCOPE:
        img = render_vectorscope(job.counts, job.intensity, job.cs, job.white)
    elif job.kind == WAVEFORM:
        img = render_waveform(apply_channel_select(job.counts, job.sel), job.intensity,
                              job.display, job.n_components, job.yuv_mode)
    else:
        counts = apply_channel_select(job.counts, job.sel).to(torch.int32)
        hi = histogram_hi_max(counts, job.sel, job.n_pixels, job.level_fixed,
                              job.level_ratio_permille)
        levels, hi_eff = histogram_levels(counts, hi, job.sel, job.logscale)
        img = render_histogram(levels, hi_eff, job.level_height, job.display, job.n_components,
                               job.yuv_mode)
    if job.graticule is not None:
        img = blend_overlay(img, job.graticule)
    return zoom_center(img, zoom=job.zoom) if job.kind == VECTORSCOPE else img


class _Job(ctypes.Structure):
    """Mirror of ``RenderJob`` in ``scope_render.cu``."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "kind", "out_h", "out_w", "block0", "vec", "intensity", "white", "display", "n_bands",
        "band_h", "band_w")] + [
        ("order", ctypes.c_int * 3), ("sel", ctypes.c_int * 3), ("bands", ctypes.c_int * 3),
        ("tint", (ctypes.c_int * 3) * 3), ("hi_mode", ctypes.c_int), ("logscale", ctypes.c_int),
        ("hi", ctypes.c_longlong), ("counts", ctypes.c_void_p), ("overlay", ctypes.c_void_p),
        ("zoom", ctypes.c_void_p), ("n_pixels", ctypes.c_void_p), ("out", ctypes.c_void_p)]


class _Params(ctypes.Structure):
    """Mirror of ``RenderParams`` in ``scope_render.cu``."""

    _fields_ = [("n_jobs", ctypes.c_int), ("blocks", ctypes.c_int), ("jobs", _Job * MAX_JOBS)]


def _job_params(job: StatJob, out: torch.Tensor, block0: int) -> _Job:
    """One job's by-value entry, drawing into ``out``, its blocks from
    ``block0``."""
    h, w = stat_image_shape(job)
    n = _n_bands(job)
    aligned = [t for t in (out, job.graticule) if t is not None]
    j = _Job(job.kind, h, w, block0,
             int(w % _RUN == 0 and all(t.data_ptr() % 16 == 0 for t in aligned)),
             job.intensity, int(job.white), int(DisplayMode.OVERLAY if n == 1 else job.display), n)
    j.order[:] = _disp_order(job.yuv_mode)
    j.sel[:] = [int(v) for v in job.sel]
    j.bands[:] = (_bands(job.n_components) + (0,))[:3]
    j.counts = job.counts.data_ptr()
    j.overlay = None if job.graticule is None else job.graticule.data_ptr()
    j.out = out.data_ptr()
    if job.kind == VECTORSCOPE:
        for c, row in enumerate(zip(*_vs_tint(job.cs))):
            j.tint[c][:] = row
        if job.zoom > 1.01:
            j.zoom = _zoom_index(VS_SIZE, job.zoom, out.device).data_ptr()
        return j
    j.band_h, j.band_w = (256, job.counts.shape[-1]) if job.kind == WAVEFORM else (
        job.level_height, 256)
    tint = TINT_Q12 if job.kind == WAVEFORM else TINT_U8
    for b in range(3):
        j.tint[b][:] = [int(v) for v in tint[b]]
    if job.kind == HISTOGRAM:
        j.logscale = int(job.logscale)
        if job.level_fixed > 0:
            j.hi_mode, j.hi = _HI_HOST, max(1, job.level_fixed)
        elif job.level_ratio_permille > 0 and isinstance(job.n_pixels, torch.Tensor):
            j.hi_mode, j.hi = _HI_RATIO, job.level_ratio_permille
            j.n_pixels = job.n_pixels.data_ptr()
        elif job.level_ratio_permille > 0:
            j.hi_mode = _HI_HOST
            j.hi = max(1, int(job.n_pixels) * job.level_ratio_permille // 1000)
        else:
            j.hi_mode = _HI_AUTO
    return j


def launch_params(jobs, outs) -> _Params:
    """The kernel's by-value table: each job with its output's address
    from ``outs`` and its range of blocks (checked by
    :func:`check_stat_jobs`)."""
    p = _Params(len(jobs), 0)
    for i, (job, out) in enumerate(zip(jobs, outs)):
        p.jobs[i] = _job_params(job, out, p.blocks)
        h, w = stat_image_shape(job)
        p.blocks += _cdiv(_cdiv(w, _RUN) * h, _THREADS)
    return p


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_tensor(what: str, t, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device`` of
    ``shape`` (None: any size on that axis)."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"draw_stat_images: {what} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"draw_stat_images: {what} on {t.device}, the first job's counts on "
                         f"{device}")
    if t.dtype != dtype or t.ndim != len(shape) or any(
            n is not None and n != m for n, m in zip(shape, t.shape)):
        raise ValueError(f"draw_stat_images: {what} must be {shape} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"draw_stat_images: {what} must be contiguous")


def check_stat_jobs(jobs) -> None:
    """KR's argument checks (what the kernel takes): raise ValueError on
    anything else.  At most :data:`MAX_JOBS` jobs, every tensor on the
    first job's device and contiguous: the counts of the job's kind, the
    graticule (h, w, 4) u8 of its image, a ratio-mode pixel count a 0-d
    int64."""
    if len(jobs) > MAX_JOBS:
        raise ValueError(f"draw_stat_images: {len(jobs)} jobs, at most {MAX_JOBS}")
    if not jobs:
        return
    dev = getattr(jobs[0].counts, "device", None)
    for i, job in enumerate(jobs):
        what = f"job {i}"
        if job.kind == VECTORSCOPE:
            _check_tensor(f"{what}'s counts", job.counts, (256, 256), torch.uint8, dev)
        elif job.kind == WAVEFORM:
            _check_tensor(f"{what}'s counts", job.counts, (3, 256, None), torch.uint8, dev)
        elif job.kind == HISTOGRAM:
            _check_tensor(f"{what}'s counts", job.counts, (3, 256), torch.int32, dev)
            if job.level_fixed <= 0 and job.level_ratio_permille > 0 and isinstance(
                    job.n_pixels, torch.Tensor):
                _check_tensor(f"{what}'s pixel count", job.n_pixels, (), torch.int64, dev)
        else:
            raise ValueError(f"draw_stat_images: {what} has no kind {job.kind}")
        if job.graticule is not None:
            _check_tensor(f"{what}'s graticule", job.graticule,
                          (*stat_image_shape(job), 4), torch.uint8, dev)


def draw_stat_images(jobs) -> list:
    """KR: the (h, w, 4) u8 image of each :class:`StatJob`, in order.  Jobs
    whose counts are on the CPU run the plain version,
    :func:`draw_stat_plain`; on a card the kernel draws them all in one
    launch (counted in ``draw_stat_images.launches``), byte for byte the
    plain version's images (logscale: the same float order; torch's
    ``log`` and the kernel's ``logf`` are the same CUDA function)."""
    jobs = list(jobs)
    if not jobs:
        return []
    dev = jobs[0].counts.device
    if dev.type == "cpu":
        return [draw_stat_plain(job) for job in jobs]
    if dev.type != "cuda":
        raise ValueError(f"draw_stat_images: unsupported device {dev}")
    check_stat_jobs(jobs)
    outs = [torch.empty((*stat_image_shape(job), 4), dtype=torch.uint8, device=dev)
            for job in jobs]
    # an empty image (a waveform of no columns) takes no part in the launch
    live = [(j, o) for j, o in zip(jobs, outs) if o.numel()]
    if not live:
        return outs
    params = launch_params([j for j, _ in live], [o for _, o in live])
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.ocm_scope_render(ctypes.byref(params), ctypes.sizeof(params),
                                  _kernels.stream_handle(dev))
    draw_stat_images.launches += 1
    _kernels.check(rc, "scope_render")
    return outs


draw_stat_images.launches = 0
