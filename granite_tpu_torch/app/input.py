"""Input tracking (copy of granite_tpu/app/input.py; reference:
application/input/input.hpp InputTracker).

Bit-packed key/mouse state, Pressed/Released/Repeat events dispatched
through the EventManager, relative mouse deltas, and a WASD+mouse
binding that drives FPSCamera (the reference camera reacts to
KeyboardEvent/MouseMoveEvent the same way).  Headless platforms feed
events programmatically (tests, replay files); a windowed platform
would translate its native events into these calls.
"""

from __future__ import annotations

from enum import IntEnum

from ..event.manager import Event, EventManager


class Key(IntEnum):
    """input.hpp:79 Key (order preserved for bit-packing parity)."""
    UNKNOWN = 0
    A = 1; B = 2; C = 3; D = 4; E = 5; F = 6; G = 7; H = 8; I = 9  # noqa
    J = 10; K = 11; L = 12; M = 13; N = 14; O = 15; P = 16; Q = 17  # noqa
    R = 18; S = 19; T = 20; U = 21; V = 22; W = 23; X = 24; Y = 25  # noqa
    Z = 26  # noqa
    RETURN = 27
    LEFT_CTRL = 28
    LEFT_ALT = 29
    LEFT_SHIFT = 30
    SPACE = 31
    ESCAPE = 32
    LEFT = 33; RIGHT = 34; UP = 35; DOWN = 36  # noqa
    D1 = 37; D2 = 38; D3 = 39; D4 = 40; D5 = 41  # noqa
    D6 = 42; D7 = 43; D8 = 44; D9 = 45; D0 = 46  # noqa
    COUNT = 47


class MouseButton(IntEnum):
    LEFT = 0
    MIDDLE = 1
    RIGHT = 2


class KeyState(IntEnum):
    PRESSED = 0
    RELEASED = 1
    REPEAT = 2


class KeyboardEvent(Event):
    def __init__(self, key: Key, state: KeyState):
        self.key = key
        self.state = state


class MouseButtonEvent(Event):
    def __init__(self, button: MouseButton, x: float, y: float,
                 pressed: bool):
        self.button = button
        self.x = x
        self.y = y
        self.pressed = pressed


class MouseMoveEvent(Event):
    def __init__(self, dx: float, dy: float, abs_x: float, abs_y: float,
                 key_state: int, button_state: int):
        self.delta_x = dx
        self.delta_y = dy
        self.abs_x = abs_x
        self.abs_y = abs_y
        self._keys = key_state
        self._buttons = button_state

    def get_key_pressed(self, key: Key) -> bool:        # input.hpp:580
        return bool(self._keys & (1 << int(key)))

    def get_mouse_button_pressed(self, b: MouseButton) -> bool:
        return bool(self._buttons & (1 << int(b)))


class InputTracker:
    """input.hpp:150 InputTracker — bit-packed state + event dispatch."""

    def __init__(self, manager: EventManager | None = None):
        self.key_state = 0              # uint64 bitmask (input.hpp:240)
        self.mouse_button_state = 0
        self.mouse_x = 0.0
        self.mouse_y = 0.0
        self.mouse_active = False
        self._manager = manager or EventManager.get()
        # Optional UI filter (ui_manager.hpp input hooks): called as
        # filter('press'|'move'|'release', x, y) BEFORE dispatch; a
        # True return means the UI consumed the event and the camera/
        # app handlers never see it.
        self.input_filter = None

    def key_pressed(self, key: Key) -> bool:            # input.hpp:179
        return bool(self.key_state & (1 << int(key)))

    def mouse_button_pressed(self, b: MouseButton) -> bool:
        return bool(self.mouse_button_state & (1 << int(b)))

    def key_event(self, key: Key, state: KeyState) -> None:
        bit = 1 << int(key)
        if state == KeyState.PRESSED:
            self.key_state |= bit
        elif state == KeyState.RELEASED:
            self.key_state &= ~bit
        self._manager.dispatch_inline(KeyboardEvent(key, state))

    def mouse_button_event(self, button: MouseButton, x: float, y: float,
                           pressed: bool) -> None:
        bit = 1 << int(button)
        if pressed:
            self.mouse_button_state |= bit
        else:
            self.mouse_button_state &= ~bit
        self.mouse_x = x
        self.mouse_y = y
        if self.input_filter is not None and \
                self.input_filter("press" if pressed else "release", x, y):
            return
        self._manager.dispatch_inline(
            MouseButtonEvent(button, x, y, pressed))

    def mouse_move_event_absolute(self, x: float, y: float) -> None:
        if not self.mouse_active:
            self.mouse_x = x
            self.mouse_y = y
            self.mouse_active = True
        dx = x - self.mouse_x
        dy = y - self.mouse_y
        self.mouse_x = x
        self.mouse_y = y
        if self.input_filter is not None and \
                self.input_filter("move", x, y):
            return
        self._manager.dispatch_inline(MouseMoveEvent(
            dx, dy, x, y, self.key_state, self.mouse_button_state))

    def mouse_move_event_relative(self, dx: float, dy: float) -> None:
        self.mouse_x += dx
        self.mouse_y += dy
        self._manager.dispatch_inline(MouseMoveEvent(
            dx, dy, self.mouse_x, self.mouse_y, self.key_state,
            self.mouse_button_state))

    def dispatch_current_state(self, dt: float) -> None:
        """Per-frame held-key repeat dispatch (InputTracker::
        dispatch_current_inputs analogue): held keys re-fire as
        Repeat events so frame-rate-dependent movement integrates."""
        for key in Key:
            if key in (Key.UNKNOWN, Key.COUNT):
                continue
            if self.key_pressed(key):
                self._manager.dispatch_inline(
                    KeyboardEvent(key, KeyState.REPEAT))


class FPSCameraInput:
    """Binds InputTracker events to an FPSCamera (the reference
    FPSCamera's KeyboardEvent/MouseMoveEvent handlers): WASD moves,
    held-right-mouse drag looks."""

    MOVE_SPEED = 3.0
    LOOK_SPEED = 0.005

    def __init__(self, camera, tracker: InputTracker,
                 dt: float = 1.0 / 60.0):
        self.camera = camera
        self.tracker = tracker
        self.dt = dt
        m = tracker._manager
        m.register_handler(KeyboardEvent, self._on_key)
        m.register_handler(MouseMoveEvent, self._on_move)

    def _on_key(self, ev: KeyboardEvent) -> None:
        if ev.state == KeyState.RELEASED:
            return
        step = self.MOVE_SPEED * self.dt
        fwd = {Key.W: 1.0, Key.S: -1.0}.get(ev.key, 0.0)
        right = {Key.D: 1.0, Key.A: -1.0}.get(ev.key, 0.0)
        up = {Key.SPACE: 1.0, Key.LEFT_CTRL: -1.0}.get(ev.key, 0.0)
        if fwd or right or up:
            self.camera.move(fwd * step, right * step, up * step, 1.0)

    def _on_move(self, ev: MouseMoveEvent) -> None:
        if not ev.get_mouse_button_pressed(MouseButton.RIGHT):
            return
        self.camera.rotate(-ev.delta_x * self.LOOK_SPEED,
                           -ev.delta_y * self.LOOK_SPEED, 1.0)
