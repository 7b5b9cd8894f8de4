"""The dynamic-ROI dock step's panel in one launch: the wrapper of kernel KC
and the slot table it reads.

No JAX counterpart kernel: the JAX dynamic step (``dock_step.py:485-710``)
composes its panel from XLA ops, and so does the plain version here,
``dock_step.assemble_dyn_panel`` (the preview's shading, the slot samplers,
the key legend's blend and ``compose_vstack``), which the wrapper runs for
a CPU tensor.  On a card the whole assembly is one launch of
``ops/csrc/dock_compose.cu``.  :func:`panel_table` is the static layout the
kernel reads, built once per step by ``make_dock_step(dynamic_roi=True)``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _kernels
from ..config import ShowKey

# slot kinds, as dock_compose.cu numbers them: the ROI preview (the
# capture's planes, shaded by the rect), a static nearest resize
# (vectorscope, histogram), the waveform (rect-mapped columns), an overlay
# fitted to the rect, focus peaking at actual size, false colour with its
# key legend
PREVIEW, NEAREST, WAVEFORM, FITTED, ACTUAL, KEYED = range(6)
MAX_SLOTS = 7  # dock_step.SCOPE_ORDER


class Slot(NamedTuple):
    """One scope's band of the panel, as the kernel draws it."""

    name: str  # the scope (``dock_step.SCOPE_ORDER``): its image's key
    kind: int
    band: tuple[int, int, int, int]  # (x0, y0, w, h) on the panel
    # the source's shape as the kernel takes it: (4, sh, sw) u8 planes for
    # PREVIEW, else (h, w) pixels, (h, w, 4) u8 or packed (h, w) int32
    src: tuple[int, ...]
    parade: int = 1  # WAVEFORM: components side by side
    key_wide: bool = False  # KEYED: the canvas adds a tenth of the rect's width (OUTSIDE)
    key_tall: bool = False  # KEYED: ... or a fifth of its height (BELOW)


class PanelTable(NamedTuple):
    """The dynamic step's static panel layout: the slots in drawing order
    (a later one draws over an earlier one), the capture the rect is clamped
    into, the key legend's texture and whether the index math needs 64
    bits."""

    out_w: int
    out_h: int
    capture: tuple[int, int]  # (sw, sh)
    slots: tuple[Slot, ...]
    legend: Optional[torch.Tensor] = None  # KEYED: (lh, lw, 4) u8
    wide: bool = False


def panel_table(names, rects: dict, dims: dict, capture: tuple[int, int],
                out: tuple[int, int], *, fp_actual: bool = False, wv_parade: int = 1,
                show_key: ShowKey = ShowKey.NONE,
                legend: Optional[torch.Tensor] = None) -> PanelTable:
    """The slot table of the shown scopes ``names`` (in ``SCOPE_ORDER``):
    their bands ``rects`` (``dock_step._layout``), the stat images' (w, h)
    ``dims``, the (sw, sh) capture and the (out_w, out_h) panel.
    ``fp_actual``: focus peaking at actual size; ``wv_parade``: the
    waveform's components side by side (1 unless parade); ``show_key`` and
    its ``legend`` texture: the false-colour slot's key."""
    sw, sh = capture
    if len(names) > MAX_SLOTS:
        raise ValueError(f"panel_table: {len(names)} slots, at most {MAX_SLOTS}")
    slots = []
    for name in names:
        band = tuple(int(v) for v in rects[name])
        if name == "roi":
            slots.append(Slot(name, PREVIEW, band, (4, sh, sw)))
        elif name in ("vectorscope", "histogram"):
            slots.append(Slot(name, NEAREST, band, (dims[name][1], dims[name][0])))
        elif name == "waveform":
            slots.append(Slot(name, WAVEFORM, band, (dims[name][1], dims[name][0]),
                              parade=int(wv_parade)))
        elif name == "falsecolor" and show_key != ShowKey.NONE:
            slots.append(Slot(name, KEYED, band, (sh, sw), key_wide=show_key == ShowKey.OUTSIDE,
                              key_tall=show_key == ShowKey.BELOW))
        elif name == "focuspeaking" and fp_actual:
            slots.append(Slot(name, ACTUAL, band, (sh, sw)))
        else:
            slots.append(Slot(name, FITTED, band, (sh, sw)))
    if any(s.kind == KEYED for s in slots) and legend is None:
        raise ValueError("panel_table: the key legend's slot needs its texture")
    slots = tuple(slots)
    return PanelTable(out[0], out[1], (sw, sh), slots, legend,
                      index_bound(out, capture, slots, legend) >= 1 << 31)


def index_bound(out, capture, slots, legend=None) -> int:
    """A bound on every product of the kernel's index math: a band
    coordinate (under the panel's or a band's largest side, plus one) times
    a source size (under twice the largest capture, source or legend side,
    plus two: the key's canvas is at most 1.2 rects) times the parade's
    components (at least 3)."""
    d = max([out[0], out[1]] + [max(s.band[2:]) for s in slots]) + 1
    n = max([capture[0], capture[1], 1] + [max(s.src[-2:]) for s in slots]
            + ([] if legend is None else list(legend.shape[:2])))
    return d * (2 * n + 2) * max([3] + [s.parade for s in slots])


class _Slot(ctypes.Structure):
    """Mirror of ``ComposeSlot`` in ``dock_compose.cu``."""

    _fields_ = [("kind", ctypes.c_int), ("x0", ctypes.c_int), ("y0", ctypes.c_int),
                ("w", ctypes.c_int), ("h", ctypes.c_int), ("src_h", ctypes.c_int),
                ("src_w", ctypes.c_int), ("parade", ctypes.c_int), ("key_wide", ctypes.c_int),
                ("key_tall", ctypes.c_int), ("key_h", ctypes.c_int), ("key_w", ctypes.c_int),
                ("src", ctypes.c_void_p), ("key", ctypes.c_void_p)]


class _Params(ctypes.Structure):
    """Mirror of ``ComposeParams`` in ``dock_compose.cu``."""

    _fields_ = [("n_slots", ctypes.c_int), ("out_w", ctypes.c_int), ("out_h", ctypes.c_int),
                ("sw", ctypes.c_int), ("sh", ctypes.c_int), ("wide", ctypes.c_int),
                ("slots", _Slot * MAX_SLOTS)]


def launch_params(table: PanelTable, images: dict) -> _Params:
    """The kernel's by-value table: ``table`` with each slot's source
    address from ``images`` (checked by :func:`check_panel_inputs`)."""
    p = _Params(len(table.slots), table.out_w, table.out_h, *table.capture, int(table.wide))
    for i, s in enumerate(table.slots):
        key = (0, 0, None) if s.kind != KEYED else (*table.legend.shape[:2],
                                                     table.legend.data_ptr())
        p.slots[i] = _Slot(s.kind, *s.band, *s.src[-2:], s.parade, int(s.key_wide),
                           int(s.key_tall), key[0], key[1], images[s.name].data_ptr(), key[2])
    return p


def _check_image(what: str, t, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` of ``shape``
    pixels: (4, h, w) u8 planes for a 3-long ``shape``, else (h, w, 4) u8 or
    packed (h, w) int32; none of them empty."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"compose_dyn_panel: {what} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"compose_dyn_panel: {what} on {t.device}, the rect on {device}")
    if len(shape) == 3:
        ok = t.dtype == torch.uint8 and tuple(t.shape) == shape
    else:
        ok = (t.dtype == torch.uint8 and tuple(t.shape) == (*shape, 4)) or (
            t.dtype == torch.int32 and tuple(t.shape) == shape)
    if not ok:
        want = f"(4, {shape[1]}, {shape[2]}) u8" if len(shape) == 3 else (
            f"({shape[0]}, {shape[1]}, 4) u8 or ({shape[0]}, {shape[1]}) int32")
        raise ValueError(f"compose_dyn_panel: {what} must be {want}, got {tuple(t.shape)} "
                         f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"compose_dyn_panel: {what} must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"compose_dyn_panel: {what} is empty")


def check_panel_inputs(table: PanelTable, images: dict, rect) -> None:
    """KC's argument checks (what the kernel takes): raise ValueError on
    anything else.  ``rect``: a contiguous (4,) int32 tensor; ``images``:
    each slot's source on the rect's device, of the slot's shape."""
    if not isinstance(rect, torch.Tensor) or rect.dtype != torch.int32 or rect.shape != (4,) \
            or not rect.is_contiguous():
        raise ValueError(f"compose_dyn_panel: rect must be a contiguous (4,) int32 tensor, got "
                         f"{getattr(rect, 'shape', rect)} {getattr(rect, 'dtype', '')}")
    if len(table.slots) > MAX_SLOTS:
        raise ValueError(f"compose_dyn_panel: {len(table.slots)} slots, at most {MAX_SLOTS}")
    for s in table.slots:
        if s.name not in images:
            raise ValueError(f"compose_dyn_panel: no image for the {s.name} slot")
        _check_image(s.name, images[s.name], s.src, rect.device)
        if s.kind == KEYED:
            lg = table.legend
            shape = tuple(lg.shape[:2]) if isinstance(lg, torch.Tensor) else (1, 1)
            _check_image("the key legend", lg, shape, rect.device)


def compose_dyn_panel(table: PanelTable, images: dict, rect: torch.Tensor) -> torch.Tensor:
    """KC: the dynamic-ROI step's (out_h, out_w, 4) u8 panel from its slot
    table, its images (the scope name -> the slot's source: for ``roi`` the
    (4, sh, sw) u8 capture planes, for the others their (h, w, 4) u8 or
    packed (h, w) int32 image) and its (4,) int32 rect, which the kernel
    reads on the device and clamps into the capture
    (:func:`convert.clamp_rect`): a new rect changes no launch.  A CPU rect
    runs the plain version, ``dock_step.assemble_dyn_panel``; a CUDA rect
    launches the kernel, whose panel equals it byte for byte."""
    dev = rect.device
    if dev.type == "cpu":
        # the plain version lives beside the torch helpers it shares with the
        # static step; dock_step imports this module
        from ..dock_step import assemble_dyn_panel

        return assemble_dyn_panel(table, images, rect)
    if dev.type != "cuda":
        raise ValueError(f"compose_dyn_panel: unsupported device {dev}")
    check_panel_inputs(table, images, rect)
    out = torch.empty((table.out_h, table.out_w, 4), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    params = launch_params(table, images)
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.ocm_dock_compose(ctypes.byref(params), ctypes.sizeof(params), rect.data_ptr(),
                                  out.data_ptr(), _kernels.stream_handle(dev))
    compose_dyn_panel.launches += 1
    _kernels.check(rc, "dock_compose")
    return out


compose_dyn_panel.launches = 0
