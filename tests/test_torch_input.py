"""The port's input tracking (granite_tpu_torch/app/input.py) over the
port's EventManager and FPSCamera: tests/test_input.py's four cases, each
event sequence run through both packages, the key and button state, the
dispatched events and the camera poses equal (poses within 1e-6)."""

import numpy as np
import pytest

from granite_tpu.app import input as JI
from granite_tpu.event.manager import EventManager as JaxEventManager
from granite_tpu.scene.camera import FPSCamera as JaxCamera
from granite_tpu_torch.app import input as TI
from granite_tpu_torch.event.manager import EventManager
from granite_tpu_torch.scene.camera import FPSCamera

PACKAGES = {"port": (TI, EventManager, FPSCamera),
            "jax": (JI, JaxEventManager, JaxCamera)}


def _tracker(kind):
    I, Manager, _ = PACKAGES[kind]
    return I, I.InputTracker(Manager())


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_key_state_bitmask(kind):
    I, t = _tracker(kind)
    assert not t.key_pressed(I.Key.W)
    t.key_event(I.Key.W, I.KeyState.PRESSED)
    t.key_event(I.Key.A, I.KeyState.PRESSED)
    assert t.key_pressed(I.Key.W) and t.key_pressed(I.Key.A)
    t.key_event(I.Key.W, I.KeyState.RELEASED)
    assert not t.key_pressed(I.Key.W) and t.key_pressed(I.Key.A)
    # Repeat does not change the held set (input.hpp KeyState::Repeat).
    t.key_event(I.Key.A, I.KeyState.REPEAT)
    assert t.key_pressed(I.Key.A)
    assert t.key_state == 1 << int(I.Key.A)


def test_enums_match_jax():
    for name in ("Key", "MouseButton", "KeyState"):
        assert [(m.name, int(m)) for m in getattr(TI, name)] == \
            [(m.name, int(m)) for m in getattr(JI, name)]


def _mouse_sequence(kind):
    I, t = _tracker(kind)
    moves = []
    t._manager.register_handler(I.MouseMoveEvent, lambda e: moves.append(
        (e.delta_x, e.delta_y, e.abs_x, e.abs_y,
         e.get_mouse_button_pressed(I.MouseButton.RIGHT))))
    t.mouse_button_event(I.MouseButton.RIGHT, 10, 10, True)
    pressed = t.mouse_button_pressed(I.MouseButton.RIGHT)
    t.mouse_move_event_absolute(10, 10)      # first move primes state
    t.mouse_move_event_absolute(14, 7)
    t.mouse_move_event_relative(-2.5, 1.25)
    t.mouse_button_event(I.MouseButton.RIGHT, 14, 7, False)
    return pressed, moves, t.mouse_button_state, (t.mouse_x, t.mouse_y)


def test_mouse_buttons_and_deltas():
    got, want = _mouse_sequence("port"), _mouse_sequence("jax")
    assert got == want
    pressed, moves, buttons, _ = got
    assert pressed and buttons == 0
    assert moves[1][:2] == (4, -3) and moves[1][4]


def _keyboard_sequence(kind):
    I, t = _tracker(kind)
    seen = []
    t._manager.register_handler(I.KeyboardEvent, lambda e: seen.append(
        (e.key.name, e.state.name)))
    t.key_event(I.Key.W, I.KeyState.PRESSED)
    t.key_event(I.Key.S, I.KeyState.PRESSED)
    t.dispatch_current_state(1 / 60)
    t.key_event(I.Key.S, I.KeyState.RELEASED)
    t.dispatch_current_state(1 / 60)
    return seen


def test_keyboard_events_dispatch_and_repeat():
    got, want = _keyboard_sequence("port"), _keyboard_sequence("jax")
    assert got == want
    repeats = [k for k, s in got if s == "REPEAT"]
    assert repeats == ["S", "W", "W"]


def _fly(kind, seed):
    """Seeded key presses, repeats and right-drags through FPSCameraInput;
    -> the camera pose after each step."""
    I, Manager, Camera = PACKAGES[kind]
    t = I.InputTracker(Manager())
    cam = Camera()
    cam.look_at(np.zeros(3), np.array([0.0, 0.0, -1.0]))
    I.FPSCameraInput(cam, t)
    rng = np.random.default_rng(seed)
    keys = [I.Key.W, I.Key.A, I.Key.S, I.Key.D, I.Key.SPACE,
            I.Key.LEFT_CTRL, I.Key.Q]
    poses = []
    for _ in range(30):
        op = rng.integers(0, 4)
        if op == 0:
            t.key_event(keys[rng.integers(0, len(keys))],
                        I.KeyState(int(rng.integers(0, 3))))
        elif op == 1:
            t.dispatch_current_state(1 / 60)
        elif op == 2:
            t.mouse_button_event(I.MouseButton.RIGHT, 0, 0,
                                 bool(rng.integers(0, 2)))
        else:
            t.mouse_move_event_relative(*rng.uniform(-20, 20, size=2))
        poses.append((cam.position.copy(), cam.rotation.copy()))
    return poses


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fps_camera_binding(seed):
    got, want = _fly("port", seed), _fly("jax", seed)
    for (gp, gr), (wp, wr) in zip(got, want):
        np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-6)
    # the pose moved and turned
    assert not np.allclose(got[-1][0], got[0][0]) or \
        not np.allclose(got[-1][1], got[0][1])


def test_fps_camera_binding_moves_and_looks():
    """tests/test_input.py's case on the port: W moves forward (-Z); a
    plain move does not turn, a right-drag does."""
    t = TI.InputTracker(EventManager())
    cam = FPSCamera()
    cam.look_at(np.zeros(3), np.array([0.0, 0.0, -1.0]))
    TI.FPSCameraInput(cam, t)
    p0 = cam.position.copy()
    t.key_event(TI.Key.W, TI.KeyState.PRESSED)
    t.dispatch_current_state(1 / 60)
    assert cam.position[2] < p0[2]
    r0 = cam.rotation.copy()
    t.mouse_move_event_relative(5, 0)
    assert np.allclose(cam.rotation, r0)
    t.mouse_button_event(TI.MouseButton.RIGHT, 0, 0, True)
    t.mouse_move_event_relative(5, 0)
    assert not np.allclose(cam.rotation, r0)
