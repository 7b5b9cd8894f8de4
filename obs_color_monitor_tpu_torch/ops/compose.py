"""The dock panel, the one home of its layout and assembly, for the dock
step (``dock_step.make_dock_step``) and the streaming ``models/dock.Dock``
alike; it imports nothing above ``ops``.

- :func:`panel_layout`: the reference's vertical stack and aspect rules
  (the JAX ``dock_step._layout``) as unclamped boxes; each caller keeps its
  own edge rule (the dock step draws an empty box as one pixel, the Dock
  skips it).
- :func:`assemble_panel`: the static panel, each image nearest-resized into
  its box (or focus peaking's 1:1 window), the ROI preview from the
  capture's planes (:class:`Preview`): the slot table of its layout
  (:func:`static_table`, built once per layout) drawn by
  :func:`compose_panel`.
- KC, the dock panel in one launch (no JAX counterpart kernel): a slot
  table (:class:`PanelTable`) drawn by :func:`compose_panel`, which
  launches ``ops/csrc/dock_compose.cu`` on a card and runs the table's
  plain version on the CPU.  The dynamic-ROI step's table
  (:func:`panel_table`, built once by ``make_dock_step(dynamic_roi=True)``)
  reads the rect on the device; its plain version is
  :func:`assemble_dyn_panel` (the JAX step_dyn's composite,
  ``dock_step.py:485-710``).  A static table (the settled route's and the
  static step's) reads no rect; its plain version is
  :func:`assemble_static_panel` (the resizes and :func:`compose_vstack`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels
from ..config import ShowKey
from .convert import OPAQUE_BLACK, _as_device_arg, clamp_rect, planes_to_rgba, rgba_to_packed


class Box(NamedTuple):
    """A box of the panel; ``crop``: the source's (x, y) of the box's 1:1
    window, else None (the source nearest-resized into the box)."""

    x0: int
    y0: int
    w: int
    h: int
    crop: Optional[tuple[int, int]] = None


def panel_layout(shown_dims, cx: int, cy: int, fp_actual: bool) -> dict[str, tuple[Box, Box]]:
    """The shown scopes [(name, w_src, h_src)] stacked on a (cx, cy) panel,
    each x-centred in an equal share of the height left (reference draw,
    src/scope-widget.cpp:117-170): the vectorscope square; the ROI preview,
    zebra, false colour and focus peaking (unless ``fp_actual``) at their
    source's aspect.  {name: (fit, box)}: the box fitted in the slot, and
    the box drawn, the fit but at actual size (focus peaking's centred 1:1
    window, reference set_actual_size_matrix, focuspeaking.c:203-220).
    Unclamped: a slot of a too-short panel may have no height."""
    boxes = {}
    y0 = 0
    for k, (name, w_src, h_src) in enumerate(shown_dims):
        w, h = cx, (cy - y0) // (len(shown_dims) - k)
        h_slot = h
        keep_aspect = name in ("roi", "zebra", "falsecolor") or (
            name == "focuspeaking" and not fp_actual)
        if name == "vectorscope":
            w = h = min(w, h)
        elif keep_aspect and w_src > 0 and h_src > 0:
            if w * h_src > h * w_src:
                w = h * w_src // h_src
            elif h * w_src > w * h_src:
                h = w * h_src // w_src
        fit = box = Box((cx - w) // 2, y0, w, h)
        if name == "focuspeaking" and fp_actual:
            w, h = min(w, w_src), min(h, h_src)
            box = Box((cx - w) // 2, y0, w, h, ((w_src - w) // 2, (h_src - h) // 2))
        boxes[name] = (fit, box)
        y0 += h_slot
    return boxes


@functools.lru_cache(maxsize=256)
def _nearest_index(n_src: int, n_out: int, device: torch.device) -> torch.Tensor:
    """Source index of each of ``n_out`` nearest-resize samples."""
    idx = np.minimum((np.arange(n_out) * n_src) // n_out, n_src - 1)
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def _rgba_view(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) u8 as it is, or the (H, W, 4) u8 bytes of an (H, W) int32
    packed image (no copy)."""
    if img.ndim == 2:
        return img.contiguous().view(torch.uint8).view(img.shape[0], img.shape[1], 4)
    return img


def _resize_nearest_rgba(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(H, W, 4) u8 or packed (H, W) int32 -> (oh, ow, 4) u8 nearest resize
    (the JAX ``dock_step._resize_nearest_rgba``), as a plain index gather:
    the JAX one-hot column matmul exists only because lane gathers are slow
    on a TPU."""
    x = _rgba_view(img)
    h, w = x.shape[0], x.shape[1]
    return x.index_select(0, _nearest_index(h, oh, x.device)).index_select(
        1, _nearest_index(w, ow, x.device)
    )


def _packed_image(img: torch.Tensor) -> torch.Tensor:
    """(H, W) int32 packed pixels of an (H, W, 4) u8 image (no copy when it
    is contiguous) or of a packed image as it is."""
    if img.ndim == 2:
        return img
    return rgba_to_packed(img)


def _floordiv(a, b):
    """Floor division of integer tensors, as JAX's ``//`` (the samplers
    divide negative numerators)."""
    return torch.div(a, b, rounding_mode="floor")


def _fit_dyn(slot_w: int, slot_h: int, src_w: torch.Tensor, src_h: torch.Tensor):
    """(fw, fh), 0-d int64 tensors: the largest box inside the static
    (slot_w, slot_h) band with the dynamic source aspect, by
    :func:`panel_layout`'s integer formula, so a rect equal to a static one
    gives the same panel (the JAX ``dock_step._fit_dyn``)."""
    fw = torch.where(slot_w * src_h > slot_h * src_w,
                     _floordiv(slot_h * src_w, src_h.clamp(min=1)), slot_w)
    fh = torch.where(slot_h * src_w > slot_w * src_h,
                     _floordiv(slot_w * src_h, src_w.clamp(min=1)), slot_h)
    return fw.clamp(min=1), fh.clamp(min=1)


def _dyn_sample_rgba(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W, 4) u8 or packed (H, W) int32 -> (len(sy), len(sx), 4) u8, the
    pixels at rows ``sy`` and columns ``sx`` (int64 device tensors, clamped
    into the image): a gather of the packed view, rows then columns, exact
    by construction (the JAX ``dock_step._dyn_sample_rgba``, whose one-hot
    matmul is the TPU's way around a lane gather).  ``valid`` (len(sy), len(sx))
    turns the pixels outside the fitted box opaque black."""
    x32 = _packed_image(img)
    h, w = x32.shape
    out = x32.index_select(0, sy.clamp(0, h - 1)).index_select(1, sx.clamp(0, w - 1))
    if valid is not None:
        out = torch.where(valid, out, OPAQUE_BLACK)
    return out.view(torch.uint8).view(out.shape[0], out.shape[1], 4)


def shaded_preview(planes: torch.Tensor, rect) -> torch.Tensor:
    """The ROI selection over the full capture: 50 % black outside the rect
    and a green border on its first and last rows and columns (reference
    draw_roi_range / draw_roi_rect, src/roi.c:207-265;
    ``models/dock._shaded_preview``).  ``rect`` (x0, y0, x1, y1) is a host
    sequence or a (4,) int32 tensor on the planes' device, used as given;
    (4, H, W) u8 in, (H, W, 4) u8 out."""
    r = torch.as_tensor(rect, dtype=torch.int32, device=planes.device)
    h, w = planes.shape[-2], planes.shape[-1]
    ri = torch.arange(h, dtype=torch.int32, device=planes.device)[:, None]
    ci = torch.arange(w, dtype=torch.int32, device=planes.device)[None, :]
    in_cols = (ci >= r[0]) & (ci < r[2])
    in_rows = (ri >= r[1]) & (ri < r[3])
    border = (((ri == r[1]) | (ri == r[3] - 1)) & in_cols) | (
        ((ci == r[0]) | (ci == r[2] - 1)) & in_rows)
    p = planes.to(torch.int32)
    shaded = torch.where(in_rows & in_cols, p[:3], (p[:3] * 128) // 255)
    chans = [shaded[0], shaded[1], shaded[2], p[3]]
    chans = [torch.where(border, g, c) for g, c in zip((0, 255, 0, 255), chans)]
    return planes_to_rgba(torch.stack(chans).to(torch.uint8))


def compose_vstack(patches: list, out_w: int, out_h: int) -> torch.Tensor:
    """Composite [(x0, y0, patch (h, w, 4) u8)] onto an opaque-black
    (out_h, out_w, 4) canvas (the JAX ``dock_step.compose_vstack``).

    Patches that lie inside the canvas in y-sorted, non-overlapping order
    are padded to full-width row bands on their int32 pixel view and
    concatenated; anything else (a panel too short for its scope count,
    whose slots overlap) takes the update-slice loop, which clips like the
    reference draw and keeps its last-drawn-wins order.  A host patch goes
    to the first patch's device (the default device for the first)."""
    if patches:
        first = _as_device_arg(patches[0][2])
        patches = [(x0, y0, _as_device_arg(p, first.device)) for x0, y0, p in patches]
    dev = patches[0][2].device if patches else torch.device("cpu")
    stackable = all(
        b[1] >= a[1] + a[2].shape[0] for a, b in zip(patches, patches[1:])
    ) and all(
        0 <= y0 and y0 + p.shape[0] <= out_h and 0 <= x0 and x0 + p.shape[1] <= out_w
        for x0, y0, p in patches
    )
    if not stackable:
        canvas = torch.zeros((out_h, out_w, 4), dtype=torch.uint8, device=dev)
        canvas[..., 3] = 255
        for x0, y0, patch in patches:
            h, w = patch.shape[0], patch.shape[1]
            y0c, x0c = max(y0, 0), max(x0, 0)
            y1c, x1c = min(y0 + h, out_h), min(x0 + w, out_w)
            if y1c <= y0c or x1c <= x0c:
                continue
            canvas[y0c:y1c, x0c:x1c] = patch[y0c - y0 : y1c - y0, x0c - x0 : x1c - x0]
        return canvas
    black = lambda n: torch.full((n, out_w), OPAQUE_BLACK, dtype=torch.int32, device=dev)
    bands = []
    y = 0
    for x0, y0, patch in patches:
        h, w = patch.shape[0], patch.shape[1]
        if y0 > y:
            bands.append(black(y0 - y))
        p32 = rgba_to_packed(patch)
        bands.append(torch.nn.functional.pad(p32, (x0, out_w - x0 - w), value=OPAQUE_BLACK))
        y = y0 + h
    if y < out_h:
        bands.append(black(out_h - y))
    return torch.cat(bands, dim=0).view(torch.uint8).view(out_h, out_w, 4)


class Preview(NamedTuple):
    """The ROI preview as a panel source: the capture's (4, sh, sw) u8
    planes, drawn as they are (``rect`` None) or with the selection
    ``rect`` (x0, y0, x1, y1, used as given) shaded around and outlined
    (:func:`shaded_preview`)."""

    planes: torch.Tensor
    rect: Optional[tuple[int, int, int, int]] = None

    @property
    def shape(self) -> tuple[int, int, int]:
        """The (h, w, 4) shape of the RGBA image it stands for."""
        return (self.planes.shape[-2], self.planes.shape[-1], 4)

    def rgba(self) -> torch.Tensor:
        """The (h, w, 4) u8 image itself."""
        if self.rect is None:
            return planes_to_rgba(self.planes)
        return shaded_preview(self.planes, self.rect)


def assemble_panel(images: dict, boxes: dict, out_w: int, out_h: int) -> torch.Tensor:
    """The static panel, (out_h, out_w, 4) u8: each scope's image of
    ``images`` ((H, W, 4) u8, packed (H, W) int32, or for the ROI preview a
    :class:`Preview`, by name) drawn in its :class:`Box` of ``boxes`` (by
    name, in drawing order), nearest-resized or its 1:1 window, as
    :func:`compose_vstack` stacks the patches.  The slot table comes from
    :func:`static_table`'s cache (:func:`static_inputs`);
    :func:`compose_panel` draws it (one launch for CUDA images, the plain
    version for CPU ones)."""
    return compose_panel(*static_inputs(images, boxes, out_w, out_h))


def static_inputs(images: dict, boxes: dict, out_w: int, out_h: int) -> tuple:
    """(slot table, sources) of :func:`assemble_panel`'s arguments, as
    :func:`compose_panel` takes them: the layout's table from
    :func:`static_table`'s cache, and each image by name (a
    :class:`Preview` as its planes)."""
    layout = tuple((n, *b, _source_key(images[n])) for n, b in boxes.items())
    sources = {n: img.planes if isinstance(img, Preview) else img for n, img in images.items()}
    return static_table(layout, (out_w, out_h)), sources


def _source_key(img) -> tuple:
    """What a static table takes of a panel source, in plain tuples of
    numbers and strings (which the cyclic collector stops tracking): a
    :class:`Preview`'s planes shape and selection, an image's shape."""
    if isinstance(img, Preview):
        return ("planes", tuple(img.planes.shape), img.rect)
    return tuple(img.shape)


# slot kinds, as dock_compose.cu numbers them.  The dynamic step's, which
# read the rect: the ROI preview (the capture's planes, shaded by the
# rect), the waveform (rect-mapped columns), an overlay fitted to the rect,
# focus peaking at actual size, false colour with its key legend.  The
# static panel's, which read none: the capture's planes as they are or
# shaded by a fixed selection, and a fixed 1:1 window.  Both: a nearest
# resize of a fixed source (the vectorscope, the histogram; any image of
# the static panel)
PREVIEW, NEAREST, WAVEFORM, FITTED, ACTUAL, KEYED, PLANES, WINDOW = range(8)
RECT_KINDS = frozenset((PREVIEW, WAVEFORM, FITTED, ACTUAL, KEYED))
MAX_SLOTS = 7  # dock_step.SCOPE_ORDER


class Slot(NamedTuple):
    """One scope's band of the panel, as the kernel draws it."""

    name: str  # the scope (``dock_step.SCOPE_ORDER``): its image's key
    kind: int
    band: tuple[int, int, int, int]  # (x0, y0, w, h) on the panel
    # the source's shape as the kernel takes it: (4, sh, sw) u8 planes for
    # PREVIEW and PLANES, else (h, w) pixels, (h, w, 4) u8 or packed (h, w)
    # int32
    src: tuple[int, ...]
    parade: int = 1  # WAVEFORM: components side by side
    key_wide: bool = False  # KEYED: the canvas adds a tenth of the rect's width (OUTSIDE)
    key_tall: bool = False  # KEYED: ... or a fifth of its height (BELOW)
    # PLANES: the selection (x0, y0, x1, y1) shaded around and outlined, or
    # None (the planes as they are)
    shade: Optional[tuple[int, int, int, int]] = None
    origin: tuple[int, int] = (0, 0)  # WINDOW: the source's (x, y) at the band's top left


class PanelTable(NamedTuple):
    """A panel's layout as the kernel draws it: the slots in drawing order
    (a later one draws over an earlier one; a pixel no slot covers is
    opaque black), the capture the rect is clamped into (a table with no
    slot of ``RECT_KINDS`` reads no rect), the key legend's texture and
    whether the index math needs 64 bits."""

    out_w: int
    out_h: int
    capture: tuple[int, int]  # (sw, sh)
    slots: tuple[Slot, ...]
    legend: Optional[torch.Tensor] = None  # KEYED: (lh, lw, 4) u8
    wide: bool = False


@functools.lru_cache(maxsize=64)
def static_table(layout: tuple, out: tuple[int, int]) -> PanelTable:
    """The static panel's slot table, built once per layout: ``layout`` is
    ((name, *:class:`Box`, source key), ...) in drawing order, the key as
    :func:`_source_key` gives it, and ``out`` the (out_w, out_h) panel.  A
    :class:`Preview` is a PLANES slot, a box with a ``crop`` a WINDOW slot
    (its band the patch that slicing the source gives), any other box a
    NEAREST slot."""
    if len(layout) > MAX_SLOTS:
        raise ValueError(f"static_table: {len(layout)} slots, at most {MAX_SLOTS}")
    slots = []
    for name, x0, y0, w, h, crop, src in layout:
        if src[0] == "planes":
            slots.append(Slot(name, PLANES, (x0, y0, w, h), src[1], shade=src[2]))
        elif crop is None:
            slots.append(Slot(name, NEAREST, (x0, y0, w, h), src[:2]))
        else:
            cols = range(src[1])[crop[0]:crop[0] + w]
            rows = range(src[0])[crop[1]:crop[1] + h]
            slots.append(Slot(name, WINDOW, (x0, y0, len(cols), len(rows)), src[:2],
                              origin=(cols.start, rows.start)))
    slots = tuple(slots)
    return PanelTable(out[0], out[1], (0, 0), slots, None,
                      index_bound(out, (0, 0), slots) >= 1 << 31)


def panel_table(names, rects: dict, dims: dict, capture: tuple[int, int],
                out: tuple[int, int], *, fp_actual: bool = False, wv_parade: int = 1,
                show_key: ShowKey = ShowKey.NONE,
                legend: Optional[torch.Tensor] = None) -> PanelTable:
    """The slot table of the shown scopes ``names`` (in ``SCOPE_ORDER``):
    their bands ``rects`` (``dock_step._layout``: :func:`panel_layout`'s
    fitted boxes, at least one pixel each), the stat images' (w, h)
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
                ("shade", ctypes.c_int), ("sel", ctypes.c_int * 4), ("org_x", ctypes.c_int),
                ("org_y", ctypes.c_int), ("src", ctypes.c_void_p), ("key", ctypes.c_void_p)]


class _Params(ctypes.Structure):
    """Mirror of ``ComposeParams`` in ``dock_compose.cu``."""

    _fields_ = [("n_slots", ctypes.c_int), ("out_w", ctypes.c_int), ("out_h", ctypes.c_int),
                ("sw", ctypes.c_int), ("sh", ctypes.c_int), ("wide", ctypes.c_int),
                ("slots", _Slot * MAX_SLOTS)]


@functools.lru_cache(maxsize=64)
def _params_template(table: PanelTable) -> _Params:
    """``table`` as the kernel's by-value table without the sources'
    addresses (never written: :func:`launch_params` copies it)."""
    p = _Params(len(table.slots), table.out_w, table.out_h, *table.capture, int(table.wide))
    for i, s in enumerate(table.slots):
        key = (0, 0, None) if s.kind != KEYED else (*table.legend.shape[:2],
                                                     table.legend.data_ptr())
        p.slots[i] = _Slot(s.kind, *s.band, *s.src[-2:], s.parade, int(s.key_wide),
                           int(s.key_tall), key[0], key[1], s.shade is not None,
                           (ctypes.c_int * 4)(*(s.shade or (0, 0, 0, 0))), *s.origin, None,
                           key[2])
    return p


def launch_params(table: PanelTable, images: dict) -> _Params:
    """The kernel's by-value table: ``table`` (its cached template) with
    each slot's source address from ``images`` (checked by
    :func:`check_panel_inputs`)."""
    p = _Params.from_buffer_copy(_params_template(table))
    for i, s in enumerate(table.slots):
        p.slots[i].src = images[s.name].data_ptr()
    return p


def _check_image(what: str, t, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` of ``shape``
    pixels: (4, h, w) u8 planes for a 3-long ``shape``, else (h, w, 4) u8 or
    packed (h, w) int32 at a 4-byte aligned address; none of them empty."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"dock_compose: {what} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"dock_compose: {what} on {t.device}, the panel on {device}")
    if len(shape) == 3:
        ok = t.dtype == torch.uint8 and tuple(t.shape) == shape
    else:
        ok = (t.dtype == torch.uint8 and tuple(t.shape) == (*shape, 4)) or (
            t.dtype == torch.int32 and tuple(t.shape) == shape)
    if not ok:
        want = f"(4, {shape[1]}, {shape[2]}) u8" if len(shape) == 3 else (
            f"({shape[0]}, {shape[1]}, 4) u8 or ({shape[0]}, {shape[1]}) int32")
        raise ValueError(f"dock_compose: {what} must be {want}, got {tuple(t.shape)} "
                         f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"dock_compose: {what} must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"dock_compose: {what} is empty")
    if len(shape) == 2 and t.data_ptr() % 4:
        raise ValueError(f"dock_compose: {what} is not 4-byte aligned")


def check_panel_inputs(table: PanelTable, images: dict, rect=None) -> None:
    """KC's argument checks (what the kernel takes): raise ValueError on
    anything else.  ``rect``: a contiguous (4,) int32 tensor for a table
    with a slot of ``RECT_KINDS``, else None; ``images``: each slot's
    source, of the slot's shape, on the rect's device (a static table's:
    on its first source's)."""
    if any(s.kind in RECT_KINDS for s in table.slots):
        if not isinstance(rect, torch.Tensor) or rect.dtype != torch.int32 \
                or rect.shape != (4,) or not rect.is_contiguous():
            raise ValueError(f"dock_compose: rect must be a contiguous (4,) int32 tensor, got "
                             f"{getattr(rect, 'shape', rect)} {getattr(rect, 'dtype', '')}")
    elif rect is not None:
        raise ValueError("dock_compose: a static table takes no rect")
    if len(table.slots) > MAX_SLOTS:
        raise ValueError(f"dock_compose: {len(table.slots)} slots, at most {MAX_SLOTS}")
    device = None if rect is None else rect.device
    for s in table.slots:
        if s.name not in images:
            raise ValueError(f"dock_compose: no image for the {s.name} slot")
        if device is None:
            device = getattr(images[s.name], "device", None)
        _check_image(s.name, images[s.name], s.src, device)
        if s.kind == KEYED:
            lg = table.legend
            shape = tuple(lg.shape[:2]) if isinstance(lg, torch.Tensor) else (1, 1)
            _check_image("the key legend", lg, shape, device)


@functools.lru_cache(maxsize=256)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    """0 .. n - 1 as int64 on ``device`` (a band's columns or rows)."""
    return torch.arange(n, dtype=torch.int64, device=device)


def assemble_dyn_panel(table: PanelTable, images: dict,
                       rect: torch.Tensor) -> torch.Tensor:
    """The dynamic-ROI step's (out_h, out_w, 4) u8 panel in torch ops (the
    JAX step_dyn's composite, ``dock_step.py:485-710``): the plain version
    of :func:`compose_panel`'s kernel on this table, run for a CPU rect.
    ``images``: the scope name -> the slot's source (for ``roi`` the
    capture's planes); ``rect``: the (4,) int32 rect, clamped into the
    capture here.  Every index the slot samplers gather by is an integer
    tensor computed on the device from the clamped rect."""
    device = rect.device
    rect_c = clamp_rect(rect, *table.capture)
    rx0, ry0, rx1, ry1 = rect_c.to(torch.int64)
    rw1, rh1 = (rx1 - rx0).clamp(min=1), (ry1 - ry0).clamp(min=1)
    sw = table.capture[0]

    def key_patch(img, ws, hs, jj, ii, slot):
        """The false-colour slot with its key legend: the canvas (the rect
        extended by the key strip) fitted into the band, the rect's pixels
        sampled through it and the legend texture blended over the box
        (the canvas maps affinely onto the fitted box;
        ``dock_step.py:387-405``)."""
        cw = _floordiv(rw1 * 11, 10) if slot.key_wide else rw1
        ch = _floordiv(rh1 * 12, 10) if slot.key_tall else rh1
        fw, fh = _fit_dyn(ws, hs, cw, ch)
        dxo = _floordiv(ws - fw, 2)
        cx, cy = _floordiv((jj - dxo) * cw, fw), _floordiv(ii * ch, fh)
        col_in, row_in = (jj >= dxo) & (jj < dxo + fw), ii < fh
        valid = (row_in & (cy < rh1))[:, None] & (col_in & (cx < rw1))[None, :]
        base = _dyn_sample_rgba(img, ry0 + torch.minimum(cy.clamp(min=0), rh1 - 1),
                                rx0 + torch.minimum(cx.clamp(min=0), rw1 - 1), valid)
        legend = table.legend
        lh, lw = legend.shape[0], legend.shape[1]
        lg = _dyn_sample_rgba(legend, _floordiv(ii * lh, fh).clamp(0, lh - 1),
                              _floordiv((jj - dxo) * lw, fw).clamp(0, lw - 1))
        a = torch.where(row_in[:, None] & col_in[None, :], lg[..., 3].to(torch.int32), 0)
        a = a[..., None]
        rgb = (lg[..., :3].to(torch.int32) * a + base[..., :3].to(torch.int32) * (255 - a)
               + 127) // 255
        return torch.cat([rgb.to(torch.uint8), base[..., 3:]], dim=-1)

    patches = []
    for slot in table.slots:
        x0s, y0s, ws, hs = slot.band
        img = images[slot.name]
        if slot.kind == PREVIEW:
            # the full capture with the selection shaded
            img = shaded_preview(img, rect_c)
        if slot.kind in (PREVIEW, NEAREST):
            patches.append((x0s, y0s, _resize_nearest_rgba(img, hs, ws)))
            continue
        jj, ii = _arange(ws, device), _arange(hs, device)
        if slot.kind == WAVEFORM:
            # the rect's columns stretched across the slot; in parade mode
            # through the per-component segments first
            if slot.parade > 1:
                m = _floordiv(jj * (rw1 * slot.parade), ws)
                cseg = _floordiv(m, rw1)
                src_j = cseg * sw + rx0 + (m - cseg * rw1)
            else:
                src_j = rx0 + _floordiv(jj * rw1, ws)
            patches.append((x0s, y0s, _dyn_sample_rgba(img, _nearest_index(slot.src[0], hs,
                                                                             device), src_j)))
            continue
        if slot.kind == KEYED:
            patches.append((x0s, y0s, key_patch(img, ws, hs, jj, ii, slot)))
            continue
        # content x-centred and top-aligned in its band, as panel_layout
        # places the static patch
        if slot.kind == ACTUAL:
            # 1:1 pixels, centred on the rect, cropped to the slot
            fw, fh = rw1.clamp(max=ws), rh1.clamp(max=hs)
            dxo = _floordiv(ws - fw, 2)
            src_j = rx0 + _floordiv(rw1 - fw, 2) + (jj - dxo)
            sy = ry0 + _floordiv(rh1 - fh, 2) + ii
        else:
            fw, fh = _fit_dyn(ws, hs, rw1, rh1)
            dxo = _floordiv(ws - fw, 2)
            src_j = rx0 + _floordiv((jj - dxo) * rw1, fw)
            sy = ry0 + _floordiv(ii * rh1, fh)
        valid = (ii < fh)[:, None] & ((jj >= dxo) & (jj < dxo + fw))[None, :]
        patches.append((x0s, y0s, _dyn_sample_rgba(img, sy, src_j, valid)))
    return compose_vstack(patches, table.out_w, table.out_h)


def assemble_static_panel(table: PanelTable, images: dict) -> torch.Tensor:
    """A static table's (out_h, out_w, 4) u8 panel in torch ops: the plain
    version of :func:`compose_panel`'s kernel on this table, run for CPU
    images.  Each slot's patch (the planes interleaved, shaded where the
    slot says, then nearest-resized; a nearest resize; a window's slice)
    goes onto the canvas by :func:`compose_vstack`."""
    patches = []
    for s in table.slots:
        x0, y0, w, h = s.band
        img = images[s.name]
        if s.kind == PLANES:
            img = Preview(img, s.shade).rgba()
        if s.kind == WINDOW:
            ox, oy = s.origin
            patch = _rgba_view(img)[oy:oy + h, ox:ox + w]
        else:
            patch = _resize_nearest_rgba(img, h, w)
        patches.append((x0, y0, patch))
    return compose_vstack(patches, table.out_w, table.out_h)


def compose_panel(table: PanelTable, images: dict,
                  rect: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KC: a panel's (out_h, out_w, 4) u8 image from its slot table and
    ``images`` (the scope name -> the slot's source: for a PREVIEW or
    PLANES slot the (4, sh, sw) u8 capture planes, for the others an
    (h, w, 4) u8 or packed (h, w) int32 image).  A table with a slot of
    ``RECT_KINDS`` (the dynamic step's, :func:`panel_table`) takes its
    (4,) int32 ``rect``, which the kernel reads on the device and clamps
    into the capture (:func:`convert.clamp_rect`): a new rect changes no
    launch.  Any other table (:func:`static_table`) takes none.  On the
    CPU (the rect's device, else the first source's; a table of no slot
    too) it runs the plain version, :func:`assemble_dyn_panel` or
    :func:`assemble_static_panel`; on a card it launches the kernel once,
    whose panel equals it byte for byte, counted in
    ``compose_panel.launches``; an empty panel launches nothing."""
    dynamic = any(s.kind in RECT_KINDS for s in table.slots)
    if dynamic != (rect is not None):
        raise ValueError("compose_panel: a table with a slot that reads the rect takes a rect, "
                         "any other none")
    src = rect if dynamic else images[table.slots[0].name] if table.slots else None
    dev = getattr(src, "device", torch.device("cpu"))
    if dev.type == "cpu":
        if dynamic:
            return assemble_dyn_panel(table, images, rect)
        return assemble_static_panel(table, images)
    if dev.type != "cuda":
        raise ValueError(f"compose_panel: unsupported device {dev}")
    check_panel_inputs(table, images, rect)
    out = torch.empty((table.out_h, table.out_w, 4), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    params = launch_params(table, images)
    lib = _kernels.library()
    with torch.cuda.device(dev):
        rc = lib.ocm_dock_compose(ctypes.byref(params), ctypes.sizeof(params),
                                  None if rect is None else rect.data_ptr(), out.data_ptr(),
                                  _kernels.stream_handle(dev))
    compose_panel.launches += 1
    _kernels.check(rc, "dock_compose")
    return out


compose_panel.launches = 0
