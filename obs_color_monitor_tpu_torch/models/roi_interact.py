"""Interactive ROI selection state machine (reference src/roi.c:343-521).

The reference lets the user drag a rectangle on the ROI source, with
move/resize handles whose hit zones flip outside/inside depending on the
rect size (reference handle_is_outside, src/roi.c:151-177).  This is the
same state machine driven by ``mouse_move``/``mouse_click`` events, feeding
a CaptureHub's rect each tick (reference roi_send_range, src/roi.c:478-520).

Handle flags mirror the reference's INTERACT_* bits (src/roi.c:20-33).

Copied whole from ``obs_color_monitor_tpu/models/roi_interact.py`` (pure
Python), so that the torch port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

INT_MIN = -(2**31)

DRAW_ROI_RECT = 1
DRAG_FIRST = 2
DRAG_MOVE = 4
DRAG_RESIZE = 8
HANDLE_LO = 0x010
HANDLE_LI = 0x020
HANDLE_RO = 0x040
HANDLE_RI = 0x080
HANDLE_TO = 0x100
HANDLE_TI = 0x200
HANDLE_BO = 0x400
HANDLE_BI = 0x800
HANDLE_LR_ANY = HANDLE_LO | HANDLE_RO | HANDLE_LI | HANDLE_RI
HANDLE_TB_ANY = HANDLE_TO | HANDLE_BO | HANDLE_TI | HANDLE_BI


@dataclasses.dataclass
class InteractiveROI:
    """Mouse-driven rect selection over a (width x height) scaled view."""

    width: int
    height: int
    # the committed rect; -1 = unset (full frame), reference roi_create
    x0in: int = -1
    y0in: int = -1
    x1in: int = -1
    y1in: int = -1
    # transient drag state
    x_start: int = INT_MIN
    y_start: int = INT_MIN
    x_mouse: int = 0
    y_mouse: int = 0
    flags: int = 0

    # -- geometry helpers (reference src/roi.c:146-177) ----------------------
    def _handle_size(self) -> int:
        return min(self.width, self.height) // 12

    def _is_outside(self, a0: int, a1: int) -> bool:
        return (a1 - a0) <= min(self.width, self.height) // 3

    def _axis_flags(self, a0: int, a1: int, pos: int, base: int, inside_flag: int) -> int:
        """reference make_flags_from_mouse (src/roi.c:386-409): base is the
        'outer low' flag; <<1 inner low, <<2 outer high, <<3 inner high."""
        hh = self._handle_size()
        flags = 0
        if self._is_outside(a0, a1):
            if a0 - hh <= pos <= a0:
                flags |= base
            if a1 <= pos <= a1 + hh:
                flags |= base << 2
            if a0 - hh <= pos <= a1 + hh:
                flags |= inside_flag
        else:
            if a0 <= pos <= a0 + hh:
                flags |= base << 1
            if a1 - hh <= pos <= a1:
                flags |= base << 3
            if a0 <= pos <= a1:
                flags |= inside_flag
        return flags

    def _resolved(self) -> tuple[int, int, int, int]:
        """Committed rect clamped into the frame (reference src/roi.c:484-497)."""
        x0 = max(self.x0in, 0)
        y0 = max(self.y0in, 0)
        x1 = self.x1in if 0 <= self.x1in <= self.width else self.width
        y1 = self.y1in if 0 <= self.y1in <= self.height else self.height
        return x0, y0, x1, y1

    def _handle_from_pos(self, x: int, y: int) -> int:
        fx = self._axis_flags(
            self.x0in, self.x1in, x, HANDLE_LO, HANDLE_TB_ANY | DRAW_ROI_RECT
        )
        fy = self._axis_flags(
            self.y0in, self.y1in, y, HANDLE_TO, HANDLE_LR_ANY | DRAW_ROI_RECT
        )
        return fx & fy

    # -- events (reference roi_mouse_move / roi_mouse_click) -----------------
    def mouse_move(self, x: int, y: int, leave: bool = False) -> None:
        if leave:
            self.x_start = self.y_start = INT_MIN
            self.flags = 0
            return
        self.x_mouse, self.y_mouse = x, y
        if self.x_start == INT_MIN and self.y_start == INT_MIN:
            self.flags = self._handle_from_pos(x, y)
        elif self.flags & DRAG_MOVE:
            dx, dy = x - self.x_start, y - self.y_start
            self.x0in += dx
            self.x1in += dx
            self.y0in += dy
            self.y1in += dy
            self.x_start, self.y_start = x, y

    def mouse_down(self, x: int, y: int) -> None:
        """Left button press (reference roi_mouse_click_start, roi.c:413-421)."""
        self.x_mouse, self.y_mouse = x, y
        self.x_start, self.y_start = x, y
        if self.flags & (HANDLE_LR_ANY | HANDLE_TB_ANY):
            self.flags |= DRAG_RESIZE
        elif self.flags & DRAW_ROI_RECT:
            self.flags |= DRAG_MOVE
        else:
            self.flags |= DRAG_FIRST

    def mouse_up(self, x: int, y: int) -> None:
        """Left button release (reference roi_mouse_click, roi.c:450-477)."""
        self.x_mouse, self.y_mouse = x, y
        if self.flags & DRAG_FIRST:
            ok = self.x_start != x and self.y_start != y
            self.x0in = min(self.x_start, x) if ok else -1
            self.y0in = min(self.y_start, y) if ok else -1
            self.x1in = max(self.x_start, x) if ok else -1
            self.y1in = max(self.y_start, y) if ok else -1
        elif self.flags & DRAG_RESIZE:
            dx, dy = x - self.x_start, y - self.y_start
            if self.flags & (HANDLE_LO | HANDLE_LI):
                self.x0in += dx
            if self.flags & (HANDLE_RO | HANDLE_RI):
                self.x1in += dx
            if self.flags & (HANDLE_TO | HANDLE_TI):
                self.y0in += dy
            if self.flags & (HANDLE_BO | HANDLE_BI):
                self.y1in += dy
            if self.x0in > self.x1in:
                self.x0in, self.x1in = self.x1in, self.x0in
            if self.y0in > self.y1in:
                self.y0in, self.y1in = self.y1in, self.y0in
        self.x_start = self.y_start = INT_MIN
        self.flags &= ~(DRAG_FIRST | DRAG_MOVE | DRAG_RESIZE)

    # -- output (reference roi_send_range, roi.c:478-520) --------------------
    def rect(self) -> tuple[int, int, int, int]:
        """The effective (x0, y0, x1, y1) to feed a CaptureHub."""
        return self._resolved()

    def sizing_rect(self) -> Optional[tuple[int, int, int, int]]:
        """The in-progress drag rectangle for display, or None."""
        if self.flags & DRAG_FIRST:
            return (
                min(self.x_start, self.x_mouse),
                min(self.y_start, self.y_mouse),
                max(self.x_start, self.x_mouse),
                max(self.y_start, self.y_mouse),
            )
        if self.flags & DRAG_RESIZE:
            x0, y0, x1, y1 = self.x0in, self.y0in, self.x1in, self.y1in
            dx, dy = self.x_mouse - self.x_start, self.y_mouse - self.y_start
            if self.flags & (HANDLE_LO | HANDLE_LI):
                x0 += dx
            if self.flags & (HANDLE_RO | HANDLE_RI):
                x1 += dx
            if self.flags & (HANDLE_TO | HANDLE_TI):
                y0 += dy
            if self.flags & (HANDLE_BO | HANDLE_BI):
                y1 += dy
            return x0, y0, x1, y1
        return None

    # -- indicator drawing (reference draw_roi_rect, src/roi.c:183-242) -----
    def _draw_rect_segments(self, x0, y0, x1, y1, flags):
        """Axis-aligned line segments (x0, y0, x1, y1) of the rect outline
        plus per-flag resize-handle indicator lines, exactly the vertex
        pattern of the reference's draw_roi_rect: a handle line offset by
        handle_size inside (or outside when the rect is small / an outside
        handle is hovered), with connector stubs back to the edge.

        Rects are half-open [x0, x1) x [y0, y1); drawn lines sit on the
        LAST included pixel column/row (x1-1 / y1-1) — the same pixel
        convention as the dock's _shaded_preview and the dynamic step's
        in-program border, so an overlaid indicator and an in-program
        border land on the same source pixels."""
        x1 = max(x1 - 1, x0)
        y1 = max(y1 - 1, y0)
        hh = self._handle_size()
        if flags & (HANDLE_LO | HANDLE_RO):
            x_outside = True
        elif flags & (HANDLE_LI | HANDLE_RI):
            x_outside = False
        else:
            x_outside = self._is_outside(x0, x1)
        if flags & (HANDLE_TO | HANDLE_BO):
            y_outside = True
        elif flags & (HANDLE_TI | HANDLE_BI):
            y_outside = False
        else:
            y_outside = self._is_outside(y0, y1)
        x0h = x0 - hh if x_outside else x0 + hh
        x1h = x1 + hh if x_outside else x1 - hh
        y0h = y0 - hh if y_outside else y0 + hh
        y1h = y1 + hh if y_outside else y1 - hh
        x0e = x0 if x_outside else x0h
        x1e = x1 if x_outside else x1h
        y0e = y0 if y_outside else y0h
        y1e = y1 if y_outside else y1h
        segs = [
            (x0, y1, x0, y0), (x0, y0, x1, y0),
            (x1, y0, x1, y1), (x1, y1, x0, y1),
        ]

        def handle_x(xh, x, ya, yb, outside):
            segs.append((xh, ya, xh, yb))
            if outside:
                segs.append((xh, ya, x, ya))
                segs.append((xh, yb, x, yb))

        def handle_y(xa, xb, yh, y, outside):
            segs.append((xa, yh, xb, yh))
            if outside:
                segs.append((xa, yh, xa, y))
                segs.append((xb, yh, xb, y))

        if flags & (HANDLE_LI | HANDLE_LO):
            handle_x(x0h, x0, y0e, y1e, (not y_outside) or x_outside)
        if flags & (HANDLE_RI | HANDLE_RO):
            handle_x(x1h, x1, y0e, y1e, (not y_outside) or x_outside)
        if flags & (HANDLE_TI | HANDLE_TO):
            handle_y(x0e, x1e, y0h, y0, (not x_outside) or y_outside)
        if flags & (HANDLE_BI | HANDLE_BO):
            handle_y(x0e, x1e, y1h, y1, (not x_outside) or y_outside)
        return segs

    def indicator_segments(self):
        """What the reference's roi_render draws this frame
        (src/roi.c:304-308): the SIZING rect with handles during a
        first-selection/resize drag; the COMMITTED rect with handles while
        hovering it (DRAW_ROI_RECT, also held through a move drag); else
        nothing.  Segments are in scaled-capture coordinates."""
        if self.flags & (DRAG_FIRST | DRAG_RESIZE):
            return self._draw_rect_segments(*self.sizing_rect(), self.flags)
        if self.flags & DRAW_ROI_RECT:
            return self._draw_rect_segments(*self._resolved(), self.flags)
        return []

    def apply_to(self, hub) -> None:
        """Push the effective rect into a CaptureHub each tick."""
        hub.set_roi(*self.rect())
