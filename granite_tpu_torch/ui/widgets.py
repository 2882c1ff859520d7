"""Port (host copy, unchanged code) of granite_tpu/ui/widgets.py.

Retained UI widget tree rendered through FlatRenderer.

Reference: ui/widget.hpp:49 (Widget: children, margin, minimum size,
flexible size, visibility, mouse filtering), ui/ui_manager.hpp:44
(UIManager: root children, render, input routing), window.cpp (floating
window with title bar + drag), vertical_packing.cpp /
horizontal_packing.cpp (stack layout: fixed minimums + flexible
leftover share), label.cpp, click_button.cpp, toggle_button.cpp,
slider.cpp (drag maps position to value), image_widget.cpp.

The host/device split keeps widget state and layout on the HOST (a few
hundred floats); `UIManager.render()` rasterizes into the FlatRenderer's RGBA
canvas, which composites onto the frame in the device-side UI pass
(ui/flat_renderer.py composite_overlay).  Input events route through
`filter_input_event` like the reference's UIManager EventHandler hooks:
a widget that claims the press captures the pointer until release.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .flat_renderer import FlatRenderer

CHAR_W = 6   # 5x7 bitmap glyph + 1 advance
CHAR_H = 8


class Widget:
    """ui/widget.hpp:49 — base: child list, geometry, visibility."""

    def __init__(self):
        self.children: list[Widget] = []
        self.parent: Optional[Widget] = None
        self.margin = 2.0
        self.visible = True
        self.size_is_flexible = False
        self.minimum_w = 8.0
        self.minimum_h = 8.0
        self.bg_color = None            # RGBA or None
        # geometry assigned by the parent at layout time (canvas coords)
        self.x = 0.0
        self.y = 0.0
        self.w = 0.0
        self.h = 0.0

    def add_child(self, widget: "Widget") -> "Widget":
        widget.parent = self
        self.children.append(widget)
        return widget

    def remove_child(self, widget: "Widget") -> None:
        self.children.remove(widget)
        widget.parent = None

    def set_minimum_geometry(self, w: float, h: float) -> None:
        self.minimum_w = w
        self.minimum_h = h

    # -- layout ----------------------------------------------------------
    def measure(self) -> tuple[float, float]:
        """Minimum (w, h) including children (reconfigure analogue)."""
        return self.minimum_w, self.minimum_h

    def layout(self, x: float, y: float, w: float, h: float) -> None:
        """Assign geometry; containers place children."""
        self.x, self.y, self.w, self.h = x, y, w, h

    # -- render ----------------------------------------------------------
    def render(self, fr: FlatRenderer) -> None:
        if not self.visible:
            return
        if self.bg_color is not None:
            fr.render_quad(int(self.x), int(self.y), int(self.w),
                           int(self.h), self.bg_color)
        for c in self.children:
            c.render(fr)

    # -- input (widget.hpp:147-155) --------------------------------------
    def hit_test(self, px: float, py: float) -> Optional["Widget"]:
        if not self.visible:
            return None
        if not (self.x <= px < self.x + self.w
                and self.y <= py < self.y + self.h):
            return None
        for c in reversed(self.children):       # topmost child first
            hit = c.hit_test(px, py)
            if hit is not None:
                return hit
        return self if self.wants_input() else None

    def wants_input(self) -> bool:
        return False

    def on_mouse_button_pressed(self, px: float, py: float):
        """Return self to capture the pointer (widget.hpp:147)."""
        return None

    def on_mouse_button_move(self, px: float, py: float) -> None:
        pass

    def on_mouse_button_released(self, px: float, py: float) -> None:
        pass


class VerticalPacking(Widget):
    """vertical_packing.cpp: stack children top-down; fixed children
    take their minimum height, flexible ones share the leftover."""

    HORIZONTAL = False

    def measure(self):
        w = self.minimum_w
        h = 0.0
        for c in self.children:
            if not c.visible:
                continue
            cw, ch = c.measure()
            if self.HORIZONTAL:
                w, h = w + cw + 2 * c.margin, max(h, ch + 2 * c.margin)
            else:
                w, h = max(w, cw + 2 * c.margin), h + ch + 2 * c.margin
        return max(w, self.minimum_w), max(h, self.minimum_h)

    def layout(self, x, y, w, h):
        super().layout(x, y, w, h)
        vis = [c for c in self.children if c.visible]
        main = w if self.HORIZONTAL else h
        fixed = 0.0
        n_flex = 0
        for c in vis:
            cw, ch = c.measure()
            need = (cw if self.HORIZONTAL else ch) + 2 * c.margin
            if c.size_is_flexible:
                n_flex += 1
            else:
                fixed += need
        leftover = max(main - fixed, 0.0)
        share = leftover / n_flex if n_flex else 0.0
        pos = 0.0
        for c in vis:
            cw, ch = c.measure()
            need = (cw if self.HORIZONTAL else ch) + 2 * c.margin
            span = share if c.size_is_flexible else need
            if self.HORIZONTAL:
                c.layout(x + pos + c.margin, y + c.margin,
                         span - 2 * c.margin, h - 2 * c.margin)
            else:
                c.layout(x + c.margin, y + pos + c.margin,
                         w - 2 * c.margin, span - 2 * c.margin)
            pos += span


class HorizontalPacking(VerticalPacking):
    """horizontal_packing.cpp."""

    HORIZONTAL = True


class Label(Widget):
    """label.cpp: text + optional background."""

    def __init__(self, text: str = "", color=(1, 1, 1, 1)):
        super().__init__()
        self.text = text
        self.color = color
        self.font_scale = 1

    def set_text(self, text: str) -> None:
        self.text = text

    def measure(self):
        return (max(self.minimum_w,
                    len(self.text) * CHAR_W * self.font_scale),
                max(self.minimum_h, CHAR_H * self.font_scale))

    def render(self, fr):
        if not self.visible:
            return
        if self.bg_color is not None:
            fr.render_quad(int(self.x), int(self.y), int(self.w),
                           int(self.h), self.bg_color)
        fr.render_text(self.text, int(self.x), int(self.y), self.color,
                       scale=self.font_scale)


class Image(Widget):
    """image_widget.cpp: a host RGBA array blitted into the canvas."""

    def __init__(self, rgba: np.ndarray):
        super().__init__()
        self.rgba = np.asarray(rgba, np.float32)
        self.set_minimum_geometry(rgba.shape[1], rgba.shape[0])

    def render(self, fr):
        if not self.visible:
            return
        x, y = int(self.x), int(self.y)
        h = min(int(self.h), self.rgba.shape[0],
                fr.canvas.shape[0] - y)
        w = min(int(self.w), self.rgba.shape[1],
                fr.canvas.shape[1] - x)
        if h <= 0 or w <= 0:
            return
        src = self.rgba[:h, :w]
        dst = fr.canvas[y:y + h, x:x + w]
        a = src[..., 3:4]
        dst[...] = dst * (1 - a) + src * a


class ClickButton(Widget):
    """click_button.cpp: momentary button firing on_click on release
    inside the widget."""

    def __init__(self, text: str = "",
                 on_click: Optional[Callable[[], None]] = None):
        super().__init__()
        self.text = text
        self.on_click = on_click
        self.pressed = False
        self.color = (1, 1, 1, 1)
        self.bg_color = (0.15, 0.15, 0.15, 0.9)

    def measure(self):
        return (max(self.minimum_w, len(self.text) * CHAR_W + 8),
                max(self.minimum_h, CHAR_H + 6))

    def wants_input(self):
        return True

    def on_mouse_button_pressed(self, px, py):
        self.pressed = True
        return self

    def on_mouse_button_released(self, px, py):
        inside = (self.x <= px < self.x + self.w
                  and self.y <= py < self.y + self.h)
        if self.pressed and inside and self.on_click is not None:
            self.on_click()
        self.pressed = False

    def render(self, fr):
        if not self.visible:
            return
        bg = (0.35, 0.35, 0.35, 0.95) if self.pressed else self.bg_color
        fr.render_quad(int(self.x), int(self.y), int(self.w),
                       int(self.h), bg)
        fr.render_text(self.text, int(self.x) + 4, int(self.y) + 3,
                       self.color)


class ToggleButton(ClickButton):
    """toggle_button.cpp: latched state flipped per click."""

    def __init__(self, text: str = "",
                 on_toggle: Optional[Callable[[bool], None]] = None):
        super().__init__(text)
        self.state = False
        self.on_toggle = on_toggle
        self.on_click = self._flip

    def _flip(self):
        self.state = not self.state
        if self.on_toggle is not None:
            self.on_toggle(self.state)

    def render(self, fr):
        if not self.visible:
            return
        bg = (0.2, 0.45, 0.2, 0.95) if self.state \
            else (0.15, 0.15, 0.15, 0.9)
        fr.render_quad(int(self.x), int(self.y), int(self.w),
                       int(self.h), bg)
        fr.render_text(self.text, int(self.x) + 4, int(self.y) + 3,
                       self.color)


class Slider(Widget):
    """slider.cpp: horizontal drag maps pointer x to [lo, hi]."""

    def __init__(self, text: str = "", lo: float = 0.0, hi: float = 1.0,
                 value: float = 0.5,
                 on_value: Optional[Callable[[float], None]] = None):
        super().__init__()
        self.text = text
        self.lo = lo
        self.hi = hi
        self.value = float(np.clip(value, lo, hi))
        self.on_value = on_value
        self.dragging = False

    def measure(self):
        return (max(self.minimum_w, len(self.text) * CHAR_W + 72),
                max(self.minimum_h, CHAR_H + 6))

    def wants_input(self):
        return True

    def _track(self):
        tx = self.x + len(self.text) * CHAR_W + 8
        tw = max(self.x + self.w - tx - 4, 8.0)
        return tx, tw

    def _apply(self, px):
        tx, tw = self._track()
        t = float(np.clip((px - tx) / tw, 0.0, 1.0))
        self.value = self.lo + t * (self.hi - self.lo)
        if self.on_value is not None:
            self.on_value(self.value)

    def on_mouse_button_pressed(self, px, py):
        self.dragging = True
        self._apply(px)
        return self

    def on_mouse_button_move(self, px, py):
        if self.dragging:
            self._apply(px)

    def on_mouse_button_released(self, px, py):
        self.dragging = False

    def render(self, fr):
        if not self.visible:
            return
        fr.render_quad(int(self.x), int(self.y), int(self.w),
                       int(self.h), (0.12, 0.12, 0.12, 0.9))
        fr.render_text(self.text, int(self.x) + 2, int(self.y) + 3)
        tx, tw = self._track()
        fr.render_quad(int(tx), int(self.y + self.h / 2 - 1), int(tw), 2,
                       (0.5, 0.5, 0.5, 1.0))
        t = 0.0 if self.hi == self.lo else \
            (self.value - self.lo) / (self.hi - self.lo)
        kx = tx + t * tw
        fr.render_quad(int(kx - 2), int(self.y + 2), 4,
                       int(self.h - 4), (0.9, 0.9, 0.9, 1.0))


class Window(VerticalPacking):
    """window.cpp: floating container with a draggable title bar."""

    TITLE_H = CHAR_H + 4

    def __init__(self, title: str = ""):
        super().__init__()
        self.title = title
        self.floating_position = (8.0, 8.0)
        self.bg_color = (0.05, 0.05, 0.08, 0.85)
        self._drag_origin = None

    def measure(self):
        w, h = super().measure()
        return (max(w, len(self.title) * CHAR_W + 8),
                h + self.TITLE_H)

    def layout(self, x, y, w, h):
        Widget.layout(self, x, y, w, h)
        VerticalPacking.layout(self, x, y + self.TITLE_H, w,
                               h - self.TITLE_H)
        # keep the window's own rect covering the title bar
        self.x, self.y, self.w, self.h = x, y, w, h

    def wants_input(self):
        return True            # title-bar drag + swallow clicks

    def on_mouse_button_pressed(self, px, py):
        if py < self.y + self.TITLE_H:
            self._drag_origin = (px - self.floating_position[0],
                                 py - self.floating_position[1])
            return self
        return self             # swallow background clicks

    def on_mouse_button_move(self, px, py):
        if self._drag_origin is not None:
            self.floating_position = (px - self._drag_origin[0],
                                      py - self._drag_origin[1])

    def on_mouse_button_released(self, px, py):
        self._drag_origin = None

    def render(self, fr):
        if not self.visible:
            return
        fr.render_quad(int(self.x), int(self.y), int(self.w),
                       int(self.h), self.bg_color)
        fr.render_quad(int(self.x), int(self.y), int(self.w),
                       self.TITLE_H, (0.1, 0.1, 0.25, 0.95))
        fr.render_text(self.title, int(self.x) + 4, int(self.y) + 2)
        for c in self.children:
            c.render(fr)


class UIManager:
    """ui_manager.hpp:44 — root widget list + render + input routing."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.widgets: list[Widget] = []
        self._capture: Optional[Widget] = None
        self.flat = FlatRenderer(width, height)

    def add_child(self, widget: Widget) -> Widget:
        self.widgets.append(widget)
        return widget

    def remove_child(self, widget: Widget) -> None:
        self.widgets.remove(widget)

    def reset_children(self) -> None:
        self.widgets.clear()

    def _layout(self) -> None:
        for wdg in self.widgets:
            w, h = wdg.measure()
            if isinstance(wdg, Window):
                x, y = wdg.floating_position
            else:
                x, y = wdg.x, wdg.y
            wdg.layout(x, y, w, h)

    def render(self) -> np.ndarray:
        """Layout + rasterize all roots; returns the RGBA overlay."""
        self._layout()
        self.flat.begin()
        for wdg in self.widgets:
            wdg.render(self.flat)
        return self.flat.flush()

    # -- input routing (UIManager EventHandler hooks) ---------------------
    def filter_input_event(self, kind: str, x: float, y: float) -> bool:
        """kind: 'press' | 'move' | 'release' with canvas coords.
        Returns True when the UI consumed the event (the app should not
        forward it to the camera/input tracker)."""
        self._layout()
        if kind == "press":
            for wdg in reversed(self.widgets):
                hit = wdg.hit_test(x, y)
                if hit is not None:
                    self._capture = hit.on_mouse_button_pressed(x, y)
                    return True
            return False
        if kind == "move":
            if self._capture is not None:
                self._capture.on_mouse_button_move(x, y)
                return True
            return False
        if kind == "release":
            if self._capture is not None:
                self._capture.on_mouse_button_released(x, y)
                self._capture = None
                return True
            return False
        return False
