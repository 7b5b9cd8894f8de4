"""Seeded desktop-capture NV12 frames, made on the device.

What OBS's Display Capture hands over from a streamer's monitor: flat UI,
neutral almost everywhere.  Backgrounds, window bodies, text and chrome
have chroma (128, 128), so most of a frame's pixels fall into one
vectorscope bin or a few neighbouring ones: large flat fills, where a whole
warp of the counting kernel shares one bin, and text runs, where its lanes
mix a few bins of one shared counter word.  The camera pictures of
``content`` never pile up so.

A frame, drawn back to front (every size in pixels of a 1440-line frame,
scaled with the frame's height, so a test's 640x360 frame has the same
layout as a 2560x1440 one):

- **wallpaper**: one flat colour of ``WALLPAPERS``;
- **windows**: 3 to 6, each a flat title bar (``TITLE`` px) over a flat
  body, dark (#1e1e1e) or light (#f3f3f3).  The topmost is focused: its
  title bar takes one saturated colour of ``ACCENTS``, the others a grey of
  their theme;
- **text** on each body: lines of glyphs from a seeded atlas, each glyph a
  stem or two 1-2 px wide and at most one bar, neutral, with at most two
  antialias levels (1/3, 2/3) between ink and background; ragged lines,
  indents, spaces and blank lines.  Each body shows a window of one long
  seeded document, scrolled by a seeded offset every frame, so every frame
  of a pool differs;
- **a video window** on top: a title bar over ``content.scene`` (the
  camera picture, grain included) covering 20-35 % of the frame's area: a
  shared screen often plays a video, and its pixels keep the overlays and
  the false colour at work;
- **a taskbar** (``TASKBAR`` px, dark or light) with flat icons, and **a
  cursor**, a white arrow outlined in black, somewhere new each frame.

No grain on UI pixels: a screen capture has none.  The layout, themes and
document are drawn once per stream and the scroll, cursor and video per
frame, all from one ``torch.Generator`` on the device, in float32, then
encoded by ``content.encode_nv12``, as ``content.frame_pool`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import content

WALLPAPERS = ((0, 84, 147), (32, 40, 54), (0, 99, 110), (73, 62, 98), (45, 45, 45))
ACCENTS = ((0, 120, 212), (196, 43, 28), (16, 124, 16), (136, 23, 152), (202, 80, 16))
ICONS = ((0, 120, 212), (255, 185, 0), (16, 137, 62), (232, 17, 35), (0, 153, 188),
         (142, 140, 216), (247, 99, 12), (86, 124, 115))
# theme: (body, ink, unfocused title bar, taskbar)
THEMES = {"dark": (30, 212, 50, 32), "light": (243, 31, 220, 238)}
TITLE, TASKBAR, PITCH, CELL, MARGIN, CURSOR = 32, 48, 20, 9, 12, 20
GLYPHS = 48


def _px(n: float, h: int, least: int = 1) -> int:
    return max(least, round(n * h / 1440))


def atlas(pitch: int, cell: int, gen: torch.Generator, device) -> torch.Tensor:
    """(GLYPHS, pitch, cell) u8 ink levels 0..3 (background, two antialias
    levels, ink): each glyph a stem 1-2 px wide (its second column at an
    antialias level), an optional second stem, and an optional 1 px bar at
    the top or the foot of the x-height; stems of x-height, ascender or
    descender length."""
    r = torch.rand((GLYPHS, 8), generator=gen, device=device)
    a, b = round(pitch * 0.35), max(round(pitch * 0.75), round(pitch * 0.35) + 1)
    top, bottom = round(pitch * 0.1), min(pitch, round(pitch * 0.95))
    kind = (r[:, 0] * 3).long()  # x-height, ascender, descender
    y0 = torch.where(kind == 1, top, a)
    y1 = torch.where(kind == 2, bottom, b)
    span = max(cell - 2, 1)
    s0 = (r[:, 1] * span).long()
    s1 = torch.where(r[:, 2] < 0.5, -9, (r[:, 3] * span).long())  # -9: no second stem
    wide = torch.where(r[:, 4] < 0.5, 1 + (r[:, 5] * 2).long(), 0)  # second column's level
    bar_row = torch.where(r[:, 6] < 0.4, a, torch.where(r[:, 6] < 0.7, b - 1, -9))  # -9: none
    ys = torch.arange(pitch, device=device)[None, :, None]
    xs = torch.arange(cell, device=device)[None, None, :]
    col = lambda v: v[:, None, None]  # noqa: E731
    rows = (ys >= col(y0)) & (ys < col(y1))
    lv = torch.zeros((GLYPHS, pitch, cell), dtype=torch.uint8, device=device)
    for s in (s0, s1):
        lv = torch.where(rows & (xs == col(s)), 3, lv)
        lv = torch.maximum(lv, torch.where(rows & (xs == col(s) + 1), col(wide), 0).to(torch.uint8))
    lo, hi = torch.minimum(s0, torch.where(s1 < 0, s0, s1)), torch.maximum(s0, s1)
    bar = (ys == col(bar_row)) & (xs >= col(lo)) & (xs <= col(hi) + 1)
    return torch.where(bar, torch.maximum(lv, torch.full_like(lv, 2)), lv)


def document(lines: int, cells: int, pitch: int, cell: int, gen: torch.Generator,
             device) -> torch.Tensor:
    """(lines * pitch, cells * cell) u8 ink levels: ``lines`` ragged lines
    of glyphs, with indents, spaces between words and blank lines."""
    glyphs = atlas(pitch, cell, gen, device)
    ids = torch.randint(0, GLYPHS, (lines, cells), generator=gen, device=device)
    r = torch.rand((lines, 3), generator=gen, device=device)
    space = torch.rand((lines, cells), generator=gen, device=device) < 0.18
    indent = (r[:, 0] * 4).long() * 4
    end = torch.where(r[:, 1] < 0.1, 0, indent + 8 + (r[:, 2] * (cells - 8)).long())
    c = torch.arange(cells, device=device)[None, :]
    ink = (c >= indent[:, None]) & (c < end[:, None]) & ~space
    doc = glyphs[ids] * ink[..., None, None].to(torch.uint8)  # (lines, cells, pitch, cell)
    return doc.permute(0, 2, 1, 3).reshape(lines * pitch, cells * cell)


class Desktop:
    """One stream's desktop: its layout drawn once, ``frame(i)`` its i-th
    picture as (H, W, 3) float RGB in [0, 1]."""

    def __init__(self, h: int, w: int, gen: torch.Generator, device):
        self.h, self.w, self.gen, self.dev = h, w, gen, device
        self.title, self.bar = _px(TITLE, h, 2), _px(TASKBAR, h, 2)
        self.pitch, self.cell = _px(PITCH, h, 4), _px(CELL, h, 3)
        self.margin, self.cursor = _px(MARGIN, h), _px(CURSOR, h, 3)
        desk = h - self.bar
        self.wallpaper = WALLPAPERS[self.randint(0, len(WALLPAPERS))]
        self.bar_theme = THEMES[("dark", "light")[self.randint(0, 2)]]
        self.windows = []  # (x0, y0, x1, y1, theme), back to front; the last focused
        for _ in range(self.randint(3, 7)):
            fw, fh, fx, fy, th = self.uniform(5)
            ww, wh = int(w * (0.3 + 0.3 * fw)), int(desk * (0.3 + 0.4 * fh))
            x0, y0 = int(fx * (w - ww)), int(fy * (desk - wh))
            self.windows.append((x0, y0, x0 + ww, y0 + wh,
                                 THEMES["dark" if th < 0.5 else "light"]))
        self.accent = ACCENTS[self.randint(0, len(ACCENTS))]
        # the video window: its body 16:9 at a share of the frame's area
        share, fx, fy = self.uniform(3)
        area = (0.20 + 0.15 * share) * h * w
        vw = min(w, int(math.sqrt(area * 16 / 9)))
        vh = min(desk - self.title, int(area / vw))
        vx = int(fx * (w - vw))
        vy = self.title + int(fy * (desk - self.title - vh))
        self.video = (vx, vy, vx + vw, vy + vh)
        n_icons = min(8, max(1, w // (2 * self.bar)))
        self.icons = [ICONS[self.randint(0, len(ICONS))] for _ in range(n_icons)]
        self.doc = document(2 * math.ceil(h / self.pitch) + 1, math.ceil(w / self.cell) + 1,
                            self.pitch, self.cell, gen, device)

    def uniform(self, n: int) -> list:
        """``n`` Python floats in [0, 1) from the stream's generator."""
        return torch.rand(n, generator=self.gen, device=self.dev).tolist()

    def randint(self, lo: int, hi: int) -> int:
        """One integer in [lo, hi) from the stream's generator."""
        return lo + min(hi - lo - 1, int(self.uniform(1)[0] * (hi - lo)))

    def _fill(self, img, x0, y0, x1, y1, rgb) -> None:
        img[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = torch.tensor(
            rgb, dtype=torch.float32, device=self.dev) / 255.0

    def _text(self, img, x0, y0, x1, y1, theme, scroll: int) -> None:
        """The document's rows from ``scroll`` on the body's text area."""
        bg, ink = theme[0], theme[1]
        ty0, ty1, tx0, tx1 = y0 + self.margin, y1 - self.margin, x0 + self.margin, x1 - self.margin
        if ty1 <= ty0 or tx1 <= tx0:
            return
        rows = (scroll + torch.arange(ty1 - ty0, device=self.dev)) % self.doc.shape[0]
        lv = self.doc[rows][:, :tx1 - tx0].to(torch.float32)
        grey = torch.round(bg + (ink - bg) * lv / 3.0) / 255.0
        img[ty0:ty1, tx0:tx1] = grey[..., None]

    def _window(self, img, x0, y0, x1, y1, title_rgb, body) -> None:
        self._fill(img, x0, y0 - self.title, x1, y0, title_rgb)
        self._fill(img, x0, y0, x1, y1, (body,) * 3)

    def frame(self, i: int) -> torch.Tensor:
        h, w = self.h, self.w
        img = torch.empty((h, w, 3), dtype=torch.float32, device=self.dev)
        self._fill(img, 0, 0, w, h, self.wallpaper)
        scrolls = [int(s * self.doc.shape[0]) for s in self.uniform(len(self.windows))]
        last = len(self.windows) - 1
        for k, ((x0, y0, x1, y1, theme), scroll) in enumerate(zip(self.windows, scrolls)):
            body_y0 = y0 + self.title
            self._window(img, x0, body_y0, x1, y1, self.accent if k == last else (theme[2],) * 3,
                         theme[0])
            self._text(img, x0, body_y0, x1, y1, theme, scroll)
        vx0, vy0, vx1, vy1 = self.video
        self._window(img, vx0, vy0, vx1, vy1, (THEMES["dark"][2],) * 3, 0)
        img[vy0:vy1, vx0:vx1] = content.scene(vy1 - vy0, vx1 - vx0, i, self.gen, self.dev)
        self._taskbar(img)
        cx, cy = self.uniform(2)
        self._cursor(img, int(cx * (w - self.cursor)), int(cy * (h - self.bar - self.cursor)))
        return img

    def _taskbar(self, img) -> None:
        h, w, bar = self.h, self.w, self.bar
        self._fill(img, 0, h - bar, w, h, (self.bar_theme[3],) * 3)
        side, step = max(1, bar * 3 // 5), bar
        x = (w - step * len(self.icons)) // 2
        top = h - bar + (bar - side) // 2
        for k, rgb in enumerate(self.icons):
            self._fill(img, x + k * step + (step - side) // 2, top,
                       x + k * step + (step - side) // 2 + side, top + side, rgb)

    def _cursor(self, img, x: int, y: int) -> None:
        """An arrow: a right triangle, white inside a 1 px black outline."""
        n = self.cursor
        r = torch.arange(n, device=self.dev)[:, None]
        c = torch.arange(n, device=self.dev)[None, :]
        inside = c * 3 <= r * 2
        edge = inside & ((c == 0) | (c * 3 > (r - 2) * 2) | (r == n - 1))
        patch = img[y:y + n, x:x + n]
        white = torch.ones(3, device=self.dev)
        patch[:] = torch.where(inside[..., None], torch.where(edge[..., None], 0.0, white),
                               patch)


def frame_pool(seed: int, stream: int, n: int, height: int, width: int, colorspace: str,
               device) -> list[np.ndarray]:
    """``n`` distinct NV12 desktop frames of one stream, as host buffers."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    desk = Desktop(height, width, gen, device)
    return [content.encode_nv12(desk.frame(i), colorspace).cpu().numpy() for i in range(n)]
