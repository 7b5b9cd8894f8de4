"""The host side of KC, the dynamic-ROI dock step's one-launch panel
assembly (``ops/compose.py``), on the CPU: the slot table that
``make_dock_step(dynamic_roi=True)`` builds for each slot kind and layout,
the kernel's by-value table, the wrapper's argument checks, its plain
branch, and the Dock's one assembly a dynamic frame.
The kernel itself runs on a card only (``tests/test_torch_cuda.py``,
``test_dock_compose_*``)."""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from obs_color_monitor_tpu_torch import DockConfig, dock_step, make_dock_step
from obs_color_monitor_tpu_torch import config as cfg
from obs_color_monitor_tpu_torch.graphs import _counters
from obs_color_monitor_tpu_torch.models import Dock
from obs_color_monitor_tpu_torch.ops import compose as C
from obs_color_monitor_tpu_torch.ops.graticule import key_canvas_size
from obs_color_monitor_tpu_torch.pipeline import profiler

H, W = 60, 88  # a 44x30 capture at scale 2
SW, SH = W // 2, H // 2
LUT = np.random.default_rng(3).integers(0, 256, (40, 4), np.uint8)
FP = dict(dock=DockConfig(show_focuspeaking=True))

# configuration -> (its keywords, the expected kind of each shown slot)
LAYOUTS = {
    "overlay": (dict(FP), dict(roi=C.PREVIEW, vectorscope=C.NEAREST, waveform=C.WAVEFORM,
                               histogram=C.NEAREST, zebra=C.FITTED, falsecolor=C.FITTED,
                               focuspeaking=C.FITTED)),
    "parade_outside": (dict(FP, waveform=cfg.WaveformConfig(display=cfg.DisplayMode.PARADE),
                            falsecolor=cfg.FalseColorConfig(show_key=cfg.ShowKey.OUTSIDE)),
                       dict(waveform=C.WAVEFORM, falsecolor=C.KEYED)),
    "stack_below_actual": (dict(FP, waveform=cfg.WaveformConfig(display=cfg.DisplayMode.STACK),
                                falsecolor=cfg.FalseColorConfig(show_key=cfg.ShowKey.BELOW),
                                focuspeaking=cfg.FocusPeakingConfig(actual_size=True)),
                           dict(waveform=C.WAVEFORM, falsecolor=C.KEYED,
                                focuspeaking=C.ACTUAL)),
    "lut": (dict(FP, falsecolor=cfg.FalseColorConfig(use_lut=True, lut=LUT)),
            dict(falsecolor=C.FITTED)),
    "lut_key_left": (dict(FP, falsecolor=cfg.FalseColorConfig(show_key=cfg.ShowKey.LEFT,
                                                              use_lut=True, lut=LUT)),
                     dict(falsecolor=C.KEYED)),
    "hidden": (dict(dock=DockConfig(show_roi=False, show_histogram=False, show_zebra=False)),
               dict(vectorscope=C.NEAREST, waveform=C.WAVEFORM, falsecolor=C.FITTED)),
}


def _step(kw, out=(128, 784), device="cpu"):
    return make_dock_step(H, W, out_width=out[0], out_height=out[1], dynamic_roi=True,
                          device=device, **kw)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_slot_table_per_kind(layout):
    """Each shown scope is one slot, in the layout's order, with its band,
    its kind and the source shape the kernel takes."""
    kw, kinds = LAYOUTS[layout]
    step = _step(kw)
    t = step.table
    assert (t.out_w, t.out_h, t.capture, t.wide) == (128, 784, (SW, SH), False)
    assert [s.name for s in t.slots] == list(step.rects)
    for s in t.slots:
        assert s.band == step.rects[s.name]
        if s.name in kinds:
            assert s.kind == kinds[s.name], s
        want = {C.PREVIEW: (4, SH, SW)}.get(s.kind)
        if s.kind in (C.NEAREST, C.WAVEFORM):
            want = step.dims[s.name][::-1]
        assert s.src == (want or (SH, SW)), s
    wv = [s for s in t.slots if s.kind == C.WAVEFORM]
    parade = layout == "parade_outside"
    assert all(s.parade == (3 if parade else 1) for s in wv)
    if "stack" in layout:
        assert wv[0].src == (768, SW)  # three 256-row bands
    keyed = [s for s in t.slots if s.kind == C.KEYED]
    assert [(s.key_wide, s.key_tall) for s in keyed] == {
        "parade_outside": [(True, False)], "stack_below_actual": [(False, True)],
        "lut_key_left": [(False, False)]}.get(layout, [])
    if keyed:
        x0, y0, ws, hs = keyed[0].band
        lh, lw = t.legend.shape[:2]
        assert t.legend.dtype == torch.uint8 and t.legend.shape[2] == 4
        # the legend's canvas for the band's base size (the band less the
        # key's strip)
        base = (ws * 10 // 11 if keyed[0].key_wide else ws, hs * 10 // 12 if keyed[0].key_tall
                else hs)
        assert (lw, lh) == key_canvas_size(kw["falsecolor"].show_key, *base)
    else:
        assert t.legend is None


def test_short_panel_slots_overlap_in_drawing_order():
    """A panel too short for its seven slots: the bands overlap, and the
    table keeps the order in which a later slot draws over an earlier."""
    t = _step(FP, out=(50, 5)).table
    assert [s.name for s in t.slots] == list(dock_step.SCOPE_ORDER)
    spans = [(s.band[1], s.band[1] + s.band[3]) for s in t.slots]
    assert any(b[0] < a[1] for a, b in zip(spans, spans[1:]))


def test_index_math_width():
    """The kernel's index math runs in int32 where every product fits,
    which the dock's 4K layout does by far, and in 64 bits past that."""
    t = make_dock_step(2160, 3840, dynamic_roi=True, device="cpu", **FP).table
    assert not t.wide and C.index_bound((t.out_w, t.out_h), t.capture, t.slots) < 1 << 28
    slots = (C.Slot("zebra", C.FITTED, (0, 0, 40000, 40000), (30000, 30000)),)
    assert C.index_bound((40000, 40000), (30000, 30000), slots) >= 1 << 31
    big = C.panel_table(["zebra"], {"zebra": (0, 0, 40000, 40000)}, {}, (30000, 30000),
                        (40000, 40000))
    assert big.wide
    with pytest.raises(ValueError):
        C.panel_table(["falsecolor"], {"falsecolor": (0, 0, 8, 8)}, {}, (8, 8), (8, 8),
                      show_key=cfg.ShowKey.OUTSIDE)


def _images(step, rect=(5, 4, 30, 20)):
    """The step's own slot images and rect, recorded at the wrapper."""
    seen, wrapper = {}, C.compose_panel

    def spy(table, images, r=None):
        seen.update(table=table, images=dict(images), rect=r)
        return wrapper(table, images, r)

    frame = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (H, W, 4), np.uint8))
    mp = pytest.MonkeyPatch()
    mp.setattr(dock_step.compose, "compose_panel", spy)
    try:
        out = step(frame, 0.5, torch.tensor(rect, dtype=torch.int32))
    finally:
        mp.undo()
    return seen["table"], seen["images"], seen["rect"], out.panel


@pytest.mark.parametrize("layout", ["overlay", "stack_below_actual", "lut_key_left"])
def test_launch_params_mirror_the_table(layout):
    """The kernel's by-value table: every slot's band, source dims, kind
    constants and source address, the legend's for the key slot; the
    mirror has ComposeParams' C layout."""
    step = _step(LAYOUTS[layout][0])
    table, images, _, _ = _images(step)
    p = C.launch_params(table, images)
    assert (p.n_slots, p.out_w, p.out_h, p.sw, p.sh, p.wide) == (len(table.slots), 128, 784,
                                                                 SW, SH, 0)
    for i, s in enumerate(table.slots):
        q = p.slots[i]
        assert (q.kind, q.x0, q.y0, q.w, q.h) == (s.kind, *s.band)
        assert (q.src_h, q.src_w, q.parade, q.key_wide, q.key_tall) == (
            *s.src[-2:], s.parade, s.key_wide, s.key_tall)
        assert q.src == images[s.name].data_ptr()
        if s.kind == C.KEYED:
            assert (q.key_h, q.key_w, q.key) == (*table.legend.shape[:2],
                                                 table.legend.data_ptr())
        else:
            assert (q.key_h, q.key_w, q.key) == (0, 0, None)
        assert (q.shade, tuple(q.sel), q.org_x, q.org_y) == (0, (0, 0, 0, 0), 0, 0)
    assert ctypes.sizeof(C._Slot) == 96 and C._Params.slots.offset == 24
    assert C._Slot.src.offset == 80 and ctypes.sizeof(C._Params) == 24 + 96 * C.MAX_SLOTS


def test_checks_refuse_what_the_kernel_does_not_take():
    """Device, dtype, shape, contiguity and emptiness of each source and of
    the rect: ValueError; a device that is neither the CPU nor a card
    too."""
    step = _step(LAYOUTS["parade_outside"][0])
    table, images, rect, _ = _images(step)
    C.check_panel_inputs(table, images, rect)
    packed = images["zebra"]
    rgba = packed.view(torch.uint8).view(*packed.shape, 4)
    C.check_panel_inputs(table, {**images, "zebra": rgba}, rect)  # either pixel form
    bad_images = {
        "missing": {k: v for k, v in images.items() if k != "zebra"},
        "dtype": {**images, "zebra": packed.to(torch.int64)},
        "shape": {**images, "zebra": packed[:, 1:]},
        "planes_shape": {**images, "roi": images["roi"][:3]},
        "planes_dtype": {**images, "roi": images["roi"].to(torch.int32)},
        "strided": {**images, "zebra": torch.empty((SH, 2 * SW), dtype=torch.int32)[:, ::2]},
        "device": {**images, "zebra": torch.empty((SH, SW), dtype=torch.int32, device="meta")},
        "not_a_tensor": {**images, "zebra": packed.numpy()},
    }
    for what, imgs in bad_images.items():
        with pytest.raises(ValueError):
            C.check_panel_inputs(table, imgs, rect)
            pytest.fail(what)
    for r in (rect.to(torch.int64), rect[:3], torch.zeros(8, dtype=torch.int32)[::2],
              (0, 0, 4, 4)):
        with pytest.raises(ValueError):
            C.check_panel_inputs(table, images, r)
    with pytest.raises(ValueError):
        C.check_panel_inputs(table._replace(legend=None), images, rect)
    with pytest.raises(ValueError):
        C.check_panel_inputs(table._replace(legend=table.legend[:0]), images, rect)
    with pytest.raises(ValueError):
        C.compose_panel(table, images, rect.to("meta"))
    with pytest.raises(ValueError):  # a table that reads the rect takes one
        C.compose_panel(table, images)


def test_cpu_rect_runs_the_plain_assembly():
    """For a CPU rect the wrapper is the plain version, which is the
    step's panel, and launches nothing."""
    step = _step(LAYOUTS["stack_below_actual"][0])
    table, images, rect, panel = _images(step)
    n = C.compose_panel.launches
    got = C.compose_panel(table, images, rect)
    assert C.compose_panel.launches == n
    assert torch.equal(got, C.assemble_dyn_panel(table, images, rect))
    assert torch.equal(got, panel) and got.shape == (784, 128, 4) and got.dtype == torch.uint8
    assert (C.compose_panel, "launches") in _counters()


def test_dock_counts_each_dynamic_frame_plain_on_the_cpu(monkeypatch):
    """A drag through a CPU Dock: every ``dock.dynamic`` frame assembles
    its panel with one ``compose_panel`` call on its rect, which launches
    nothing; a settled frame makes none with a rect."""
    dock = Dock(DockConfig(), roi=cfg.ROIConfig(interleave=0, target_scale=2, x0=8, y0=4,
                                                x1=32, y1=16), device="cpu")
    calls, wrapper = [], C.compose_panel

    def spy(table, images, rect=None):
        if rect is not None:
            calls.append(rect)
        return wrapper(table, images, rect)

    monkeypatch.setattr(C, "compose_panel", spy)
    rng = np.random.default_rng(2)
    planes = [rng.integers(0, 256, (72, 96), dtype=np.uint8) for _ in range(6)]
    for b in planes[:2]:
        dock.push_nv12(b[:48], b[48:])
        dock.render_async()
    assert not calls
    x0, y0, w, h, _, _ = dock._rects["roi"]
    x, y = x0 + w // 2, y0 + h // 2
    n = wrapper.launches
    profiler.reset()
    profiler.enable(True)
    try:
        dock.mouse_move(x, y)
        dock.mouse_down(x, y)
        for k, b in enumerate(planes[2:]):
            dock.mouse_move(x + 2 * (k + 1), y + k + 1)
            dock.push_nv12(b[:48], b[48:])
            dock.render_async()
            assert len(calls) == k + 1
        snap = profiler.snapshot()
    finally:
        profiler.enable(False)
        profiler.reset()
    dynamic = sum(s["name"] == "dock.dynamic" for s in snap["spans"])
    assert dynamic == 4 and len(calls) == dynamic
    assert wrapper.launches == n


# The static panel (the settled route's, the static step's): configuration
# -> (capture (h, w), panel (cx, cy), the shown scopes, focus peaking at
# actual size, the preview's selection or None, packed sources, the scopes
# left out after the layout (their bands stay taken; "one_pixel": none,
# every box at least one pixel, the static step's edge rule), extra boxes
# by name)
ALL7 = tuple(dock_step.SCOPE_ORDER)
STATIC_CASES = {
    "full_preview_packed_13x17": ((13, 17), (130, 700), ALL7, False, None, True, (), {}),
    "cropped_preview_rgba_129x131": ((129, 131), (132, 900), ALL7, False, None, False, (), {}),
    "shaded_rect_w17": ((60, 88), (17, 400), ALL7, False, (5, 4, 30, 20), True, (), {}),
    "shaded_empty_rect": ((60, 88), (130, 600), ALL7[:4], False, (10, 10, 10, 30), False, (),
                          {}),
    "actual_size_cropped": ((60, 88), (40, 900), ALL7, True, None, True, (), {}),
    "actual_size_whole_129x131": ((129, 131), (132, 1100), ALL7, True, (3, 1, 120, 128), False,
                                  (), {}),
    "too_short_overlapping": ((60, 88), (50, 5), ALL7, True, None, True, "one_pixel", {}),
    "left_out_keep_height": ((60, 88), (130, 800), ALL7, False, None, False,
                             ("waveform", "zebra"), {}),
    "window_past_the_source": ((60, 88), (132, 300), ("roi", "focuspeaking"), False, None, True,
                               (), {"focuspeaking": C.Box(41, 100, 50, 30, (70, 5))}),
}


def _static_sources(case):
    """The case's panel sources (a :class:`compose.Preview` for the roi)
    and boxes, the Dock's way: :func:`compose.panel_layout` over the
    sources' dims, the scopes left out dropped."""
    (sh, sw), (cx, cy), shown, fp_actual, sel, packed, left_out, extra = STATIC_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    dims = {"roi": (sw, sh), "vectorscope": (256, 256), "waveform": (sw, 256),
            "histogram": (256, 200), "zebra": (sw, sh), "falsecolor": (sw, sh),
            "focuspeaking": (sw, sh)}
    images = {}
    for n in shown:
        w, h = dims[n]
        if n == "roi":
            planes = torch.from_numpy(rng.integers(0, 256, (4, h, w), np.uint8))
            images[n] = C.Preview(planes, sel)
        else:
            img = torch.from_numpy(rng.integers(0, 256, (h, w, 4), np.uint8))
            images[n] = img.view(torch.int32)[..., 0] if packed else img
    layout = C.panel_layout([(n, *dims[n]) for n in shown], cx, cy, fp_actual)
    if left_out == "one_pixel":
        boxes = {n: b._replace(w=max(b.w, 1), h=max(b.h, 1)) for n, (_, b) in layout.items()}
    else:
        boxes = {n: b for n, (_, b) in layout.items()
                 if n not in left_out and b.w > 0 and b.h > 0}
    boxes.update(extra)
    return images, boxes, (cx, cy)


def _chain_reference(images, boxes, out):
    """The static panel as numpy draws it: each box's patch (the preview's
    planes interleaved, 50 % black outside its selection and a green
    border, nearest-resized by ``min(i * n_src // n_out, n_src - 1)``; a
    crop's slice) pasted in order onto an opaque-black canvas, clipped."""
    cx, cy = out
    canvas = np.zeros((cy, cx, 4), np.uint8)
    canvas[..., 3] = 255
    for n, b in boxes.items():
        img = images[n]
        if isinstance(img, C.Preview):
            p = img.planes.numpy().astype(np.int32)
            rgba = np.moveaxis(p, 0, -1).copy()
            if img.rect is not None:
                x0, y0, x1, y1 = img.rect
                ri, ci = np.arange(p.shape[1])[:, None], np.arange(p.shape[2])[None, :]
                inside = (ri >= y0) & (ri < y1) & (ci >= x0) & (ci < x1)
                border = (((ri == y0) | (ri == y1 - 1)) & (ci >= x0) & (ci < x1)) | (
                    ((ci == x0) | (ci == x1 - 1)) & (ri >= y0) & (ri < y1))
                rgba[..., :3] = np.where(inside[..., None], rgba[..., :3],
                                         rgba[..., :3] * 128 // 255)
                rgba[border] = (0, 255, 0, 255)
            src = rgba.astype(np.uint8)
        else:
            src = img.contiguous().view(torch.uint8).reshape(*img.shape[:2], 4).numpy()
        if b.crop is None:
            rows = np.minimum(np.arange(b.h) * src.shape[0] // b.h, src.shape[0] - 1)
            cols = np.minimum(np.arange(b.w) * src.shape[1] // b.w, src.shape[1] - 1)
            patch = src[rows][:, cols]
        else:
            patch = src[b.crop[1]:b.crop[1] + b.h, b.crop[0]:b.crop[0] + b.w]
        y0c, x0c = max(b.y0, 0), max(b.x0, 0)
        y1c, x1c = min(b.y0 + patch.shape[0], cy), min(b.x0 + patch.shape[1], cx)
        if y1c > y0c and x1c > x0c:
            canvas[y0c:y1c, x0c:x1c] = patch[y0c - b.y0:y1c - b.y0, x0c - b.x0:x1c - b.x0]
    return canvas


@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_static_table_plain_equals_the_chain(case):
    """Every static slot kind (the plain and the shaded preview from the
    capture's planes, a nearest resize of a packed or an (H, W, 4) source,
    focus peaking's 1:1 window), on odd shapes and panel widths, a panel
    too short for its slots and scopes left out: the table's plain version
    equals the chain byte for byte; the table is built once per layout,
    its by-value mirror carries each kind's constants, and its checks take
    no rect."""
    images, boxes, out = _static_sources(case)
    want = _chain_reference(images, boxes, out)
    C.static_table.cache_clear()
    got = C.assemble_panel(images, boxes, *out)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    table, sources = C.static_inputs(images, boxes, *out)
    assert C.static_table.cache_info()[:2] == (1, 1)  # (hits, misses)
    assert not table.wide and [s.name for s in table.slots] == list(boxes)
    assert sources == {n: img.planes if isinstance(img, C.Preview) else img
                       for n, img in images.items()}
    assert np.array_equal(C.assemble_static_panel(table, sources).numpy(), want)
    assert C.compose_panel(table, sources).shape == (out[1], out[0], 4)
    C.check_panel_inputs(table, sources)
    with pytest.raises(ValueError):
        C.check_panel_inputs(table, sources, torch.zeros(4, dtype=torch.int32))
    p = C.launch_params(table, sources)
    assert (p.n_slots, p.out_w, p.out_h, p.wide) == (len(boxes), *out, 0)
    for i, s in enumerate(table.slots):
        q, b = p.slots[i], boxes[s.name]
        assert q.kind == s.kind and q.src == sources[s.name].data_ptr()
        if isinstance(images[s.name], C.Preview):
            assert s.kind == C.PLANES and s.src == tuple(images[s.name].planes.shape)
            sel = images[s.name].rect
            assert (q.shade, tuple(q.sel)) == (sel is not None, sel or (0, 0, 0, 0))
        elif b.crop is None:
            assert s.kind == C.NEAREST and (q.x0, q.y0, q.w, q.h) == b[:4]
        else:
            # the band is the slice the window takes of the source
            sh, sw = s.src
            assert s.kind == C.WINDOW and (q.org_x, q.org_y) == b.crop
            assert (q.w, q.h) == (min(b.w, sw - b.crop[0]), min(b.h, sh - b.crop[1]))
