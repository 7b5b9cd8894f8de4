"""The dock panel's plain reference: the reference plugin's vertical stack
(src/scope-widget.cpp:99-175) of the shown scopes, each resized by nearest
sampling into its slot, over an opaque black canvas; the ROI drag's
selection drawn as the reference's roi_render draws it (src/roi.c:183-315).

Two routes, as a user sees them: a settled ROI on the whole capture, where
the waveform row shows the frame before (the waveform publishes on its
tick, src/waveform.c:394-400), and a dragged ROI, where every row shows the
rect of this frame: the preview the whole capture with the selection
shaded, each overlay the rect fitted into its row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import golden, graticule

ORDER = ("roi", "vectorscope", "waveform", "histogram", "zebra", "falsecolor", "focuspeaking")
BLACK = (0, 0, 0, 255)
GREEN = (0, 255, 0, 255)


class Frame(NamedTuple):
    """One frame's capture and what every row derives from it."""

    capture: torch.Tensor  # (sh, sw, 4) u8, the scaled frame
    vs: torch.Tensor  # (256, 256) int64 counts
    wv: torch.Tensor  # (3, 256, sw) int64 counts
    hi: torch.Tensor  # (3, 256) int64 counts


def nearest(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Nearest resize: output row i reads ``min(i * h // oh, h - 1)``."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    ri = torch.clamp(torch.arange(oh, device=dev) * h // oh, max=h - 1)
    ci = torch.clamp(torch.arange(ow, device=dev) * w // ow, max=w - 1)
    return img[ri][:, ci]


def fit(w: int, h: int, w_src: int, h_src: int) -> tuple[int, int]:
    """The largest (w, h) inside a slot with the source's aspect, in integers."""
    if w * h_src > h * w_src:
        w = h * w_src // h_src
    elif h * w_src > w * h_src:
        h = w * h_src // w_src
    return w, h


def compose(patches: list, out_w: int, out_h: int, device) -> torch.Tensor:
    canvas = torch.tensor(BLACK, dtype=torch.uint8, device=device).repeat(out_h, out_w, 1)
    for x0, y0, p in patches:
        canvas[y0:y0 + p.shape[0], x0:x0 + p.shape[1]] = p
    return canvas


class DockReference:
    """The panel and statistics that a dock configured by ``dock`` (a
    configuration file's ``dock`` object) shows for NV12 frames of
    ``height`` x ``width``.  Only the settings the configurations state
    are modelled; any other value is refused."""

    def __init__(self, dock: dict, height: int, width: int, device, ds_dtype=torch.float32):
        vs, wv, hi = dock["vectorscope"], dock["waveform"], dock["histogram"]
        if (wv["display"], wv["components"], hi["display"], hi["components"], hi["level_mode"],
                hi["logscale"], vs["color_type"], vs["zoom"], dock["falsecolor"]["show_key"],
                dock["focuspeaking"]["actual_size"]) != (
                "overlay", "rgb", "overlay", "rgb", "auto", False, "uv", 1.0, "none", False):
            raise ValueError("the reference models the overlay RGB waveform and histogram in "
                             "AUTO level mode, the UV vectorscope unzoomed, no false-colour key "
                             "and scaled focus peaking")
        self.d = dock
        self.dev = torch.device(device)
        self.ds_dtype = ds_dtype
        self.cs = {"bt601": 1, "bt709": 2}[dock["colorspace"]]
        self.scale = dock["target_scale"]
        self.h, self.w = height, width
        self.sw, self.sh = width // self.scale, height // self.scale
        self.out_w, self.out_h = dock["width"], dock["height"]
        self.shown = [n for n in ORDER if dock["show"][n]]
        lh = hi["level_height"]
        self.src_dims = {"roi": (self.sw, self.sh), "vectorscope": (256, 256),
                         "waveform": (self.sw, 256), "histogram": (256, lh),
                         "zebra": (self.sw, self.sh), "falsecolor": (self.sw, self.sh),
                         "focuspeaking": (self.sw, self.sh)}

        def on_dev(a):
            return None if a is None else torch.as_tensor(a, device=self.dev)

        self.vs_grat = on_dev(graticule.vectorscope(vs["graticule"], vs["skintone_bgr"], self.cs))
        self.hi_grat = on_dev(graticule.histogram(hi["graticule_vertical_lines"], lh))
        self.wv_lines = wv["graticule_lines"]
        self._wv_grat = {}
        fp = dock["focuspeaking"]
        c = fp["peaking_color_abgr"]
        self.peak_rgba = tuple(golden.unorm8(((c >> s) & 0xFF) / 255.0) for s in (0, 8, 16, 24))
        self.zebra_cfg = dock["zebra"]

    def wv_grat(self, width: int):
        if width not in self._wv_grat:
            g = graticule.waveform(self.wv_lines, width)
            self._wv_grat[width] = None if g is None else torch.as_tensor(g, device=self.dev)
        return self._wv_grat[width]

    # -- one frame's analysis ------------------------------------------------
    def capture(self, y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
        rgba = golden.nv12_to_rgba(y.to(self.dev), uv.to(self.dev), self.cs)
        return golden.downscale(rgba, self.scale, self.ds_dtype)

    def stats(self, cap: torch.Tensor) -> Frame:
        return Frame(cap, golden.vectorscope_counts(golden.to_yuv(cap, self.cs)),
                     golden.waveform_counts(cap), golden.histogram_counts(cap))

    def frame(self, y: torch.Tensor, uv: torch.Tensor) -> Frame:
        return self.stats(self.capture(y, uv))

    def renders(self, f: Frame) -> dict:
        d = self.d
        return {
            "vectorscope": golden.blend(golden.render_vectorscope(
                f.vs, d["vectorscope"]["intensity"], self.cs), self.vs_grat),
            "waveform": golden.blend(golden.render_waveform(f.wv, d["waveform"]["intensity"]),
                                     self.wv_grat(f.wv.shape[-1])),
            "histogram": golden.blend(golden.render_histogram(
                f.hi, d["histogram"]["level_height"]), self.hi_grat),
        }

    def overlays(self, cap: torch.Tensor, tm: float) -> dict:
        z = self.zebra_cfg
        return {
            "zebra": golden.zebra(cap, z["th_low_percent"] * 1e-2, z["th_high_percent"] * 1e-2,
                                  tm, self.cs),
            "falsecolor": golden.falsecolor(cap, self.cs),
            "focuspeaking": golden.focus_peaking(
                cap, self.d["focuspeaking"]["peaking_threshold"], self.peak_rgba),
        }

    # -- the settled route -----------------------------------------------------
    def settled_panel(self, cur: Frame, prev: Frame, tm: float) -> torch.Tensor:
        """The panel of ``cur`` with the ROI on the whole capture: the
        waveform row from ``prev``, the zebra at clock ``tm``."""
        images = {"roi": cur.capture, **self.renders(cur), **self.overlays(cur.capture, tm)}
        images["waveform"] = self.renders(prev)["waveform"]
        patches, y0 = [], 0
        for k, name in enumerate(self.shown):
            h_slot = (self.out_h - y0) // (len(self.shown) - k)
            w, h = self.out_w, h_slot
            if name == "vectorscope":
                w = h = min(w, h)
            elif name in ("roi", "zebra", "falsecolor", "focuspeaking"):
                w, h = fit(w, h, *self.src_dims[name])
            if w > 0 and h > 0:
                patches.append(((self.out_w - w) // 2, y0, nearest(images[name], h, w)))
            y0 += h_slot
        return compose(patches, self.out_w, self.out_h, self.dev)

    # -- the dragged route -------------------------------------------------------
    def dynamic_layout(self) -> dict:
        """Each shown row's static band (x0, y0, w, h): the overlays take
        the whole band and fit each frame's rect inside it."""
        rects, y0 = {}, 0
        for k, name in enumerate(self.shown):
            h_slot = (self.out_h - y0) // (len(self.shown) - k)
            w, h = self.out_w, h_slot
            if name == "vectorscope":
                w = h = min(w, h)
            elif name == "roi":
                w, h = fit(w, h, self.sw, self.sh)
            rects[name] = ((self.out_w - w) // 2, y0, max(w, 1), max(h, 1))
            y0 += h_slot
        return rects

    def rect_stats(self, cap: torch.Tensor, rect) -> Frame:
        """The statistics the dragged route publishes: the rect's vectorscope
        and histogram, and a full-width waveform whose columns outside the
        rect are zero."""
        x0, y0, x1, y1 = rect
        f = self.stats(cap[y0:y1, x0:x1])
        wv = torch.zeros((3, 256, self.sw), dtype=torch.int64, device=self.dev)
        wv[:, :, x0:x1] = f.wv
        return Frame(cap, f.vs, wv, f.hi)

    def shaded(self, cap: torch.Tensor, rect) -> torch.Tensor:
        """The whole capture, 50 % black outside the rect, a green border on
        its first and last rows and columns (src/roi.c:207-265)."""
        x0, y0, x1, y1 = rect
        dev = self.dev
        ri = torch.arange(cap.shape[0], device=dev)[:, None]
        ci = torch.arange(cap.shape[1], device=dev)[None, :]
        in_c, in_r = (ci >= x0) & (ci < x1), (ri >= y0) & (ri < y1)
        border = (((ri == y0) | (ri == y1 - 1)) & in_c) | (((ci == x0) | (ci == x1 - 1)) & in_r)
        p = cap.to(torch.int64)
        rgb = torch.where((in_r & in_c)[..., None], p[..., :3], p[..., :3] * 128 // 255)
        out = torch.cat([rgb, p[..., 3:]], dim=-1)
        out[border] = torch.tensor(GREEN, dtype=torch.int64, device=dev)
        return out.to(torch.uint8)

    def dynamic_panel(self, cap: torch.Tensor, rect, tm: float) -> torch.Tensor:
        """The panel of a frame whose ROI ``rect`` (x0, y0, x1, y1, inside
        the capture) is being dragged, with the selection's outline drawn
        over the preview row."""
        x0, y0, x1, y1 = rect
        rw, rh = x1 - x0, y1 - y0
        crop = cap[y0:y1, x0:x1]
        f = self.rect_stats(cap, rect)
        renders = self.renders(Frame(crop, f.vs, f.wv[:, :, x0:x1], f.hi))
        images = {"roi": self.shaded(cap, rect), **renders, **self.overlays(crop, tm)}
        bands = self.dynamic_layout()
        patches = []
        for name in self.shown:
            bx, by, bw, bh = bands[name]
            if name in ("roi", "vectorscope", "histogram", "waveform"):
                patches.append((bx, by, nearest(images[name], bh, bw)))
                continue
            fw, fh = fit(bw, bh, rw, rh)
            band = torch.tensor(BLACK, dtype=torch.uint8, device=self.dev).repeat(bh, bw, 1)
            dx = (bw - fw) // 2
            band[:fh, dx:dx + fw] = nearest(images[name], fh, fw)
            patches.append((bx, by, band))
        panel = compose(patches, self.out_w, self.out_h, self.dev)
        return self.outline(panel, bands["roi"], rect)

    def outline(self, panel: torch.Tensor, band, rect) -> torch.Tensor:
        """The dragged rect's outline, 1 px green, on its last included row
        and column, mapped from capture to panel pixels and clipped to the
        preview row (draw_roi_rect, src/roi.c:183-242)."""
        bx, by, bw, bh = band
        x0, y0, x1, y1 = rect
        x1, y1 = max(x1 - 1, x0), max(y1 - 1, y0)

        def mx(v):
            return bx + v * bw // self.sw

        def my(v):
            return by + v * bh // self.sh

        panel = panel.clone()
        green = torch.tensor(GREEN, dtype=torch.uint8, device=self.dev)
        for ax, ay, cx, cy in ((x0, y1, x0, y0), (x0, y0, x1, y0), (x1, y0, x1, y1),
                               (x1, y1, x0, y1)):
            sx0, sy0 = max(mx(min(ax, cx)), bx), max(my(min(ay, cy)), by)
            sx1, sy1 = min(mx(max(ax, cx)), bx + bw - 1), min(my(max(ay, cy)), by + bh - 1)
            if sx0 <= sx1 and sy0 <= sy1:
                panel[sy0:sy1 + 1, sx0:sx1 + 1] = green
        return panel
