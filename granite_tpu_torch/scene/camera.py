"""Camera / FPSCamera (copy of granite_tpu/scene/camera.py without the
unused transform_z_scale; reference: renderer/camera.hpp:32,116).
tests/test_torch_host_copies.py holds this copy equal to the original."""

from __future__ import annotations

import numpy as np

from ..math.muglm import (
    INFINITE_FAR_PLANE, look_at_quat, mat4_cast, ortho, perspective,
    quat_from_axis_angle, quat_mul, quat_normalize, quat_rotate, translate,
)


class Camera:
    def __init__(self):
        self.position = np.zeros(3, np.float32)
        self.rotation = np.array([1, 0, 0, 0], np.float32)
        self.fovy = 0.5 * np.pi * 0.55
        self.aspect = 16 / 9
        self.znear = 0.1
        self.zfar = 1000.0

    def look_at(self, eye, at, up=(0.0, 1.0, 0.0)) -> None:
        self.position = np.asarray(eye, np.float32)
        self.rotation = look_at_quat(np.asarray(at, np.float32)
                                     - self.position, up)

    def set_depth_range(self, znear: float, zfar: float) -> None:
        self.znear = znear
        self.zfar = zfar

    def set_fovy(self, fovy: float) -> None:
        self.fovy = fovy

    def set_aspect(self, aspect: float) -> None:
        self.aspect = aspect

    def set_ortho(self, enabled: bool, xmag: float = 1.0,
                  ymag: float = 1.0) -> None:
        """Orthographic projection (glTF cameras.orthographic; muglm
        reverse-Z ortho)."""
        self.ortho = enabled
        self.xmag = xmag
        self.ymag = ymag

    def get_view(self) -> np.ndarray:
        return mat4_cast(self.rotation) @ translate(-self.position)

    def get_projection(self) -> np.ndarray:
        if getattr(self, "ortho", False):
            zf = self.zfar if self.zfar > 0 else 1000.0
            return ortho(-self.xmag, self.xmag, -self.ymag, self.ymag,
                         self.znear, zf)
        return perspective(self.fovy, self.aspect, self.znear,
                           self.zfar if self.zfar > 0 else
                           INFINITE_FAR_PLANE)

    def get_front(self) -> np.ndarray:
        return quat_rotate(_conj(self.rotation), [0, 0, -1])

    def get_right(self) -> np.ndarray:
        return quat_rotate(_conj(self.rotation), [1, 0, 0])

    def get_up(self) -> np.ndarray:
        return quat_rotate(_conj(self.rotation), [0, 1, 0])


def _conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]], np.float32)


class FPSCamera(Camera):
    """Input-driven fly camera (camera.hpp:116); app/input.FPSCameraInput
    drives its move and rotate."""

    def __init__(self):
        super().__init__()
        self.speed = 3.0
        self.turn_speed = 1.5

    def move(self, forward: float, right: float, up: float,
             dt: float) -> None:
        self.position = (self.position
                         + self.get_front() * (forward * self.speed * dt)
                         + self.get_right() * (right * self.speed * dt)
                         + self.get_up() * (up * self.speed * dt)).astype(
                             np.float32)

    def rotate(self, yaw: float, pitch: float, dt: float) -> None:
        dy = quat_from_axis_angle([0, 1, 0], yaw * self.turn_speed * dt)
        dp = quat_from_axis_angle(self.get_right(),
                                  pitch * self.turn_speed * dt)
        # world-space increments compose on the right of the view
        # rotation's inverse; equivalently pre-multiply the conjugates.
        self.rotation = quat_normalize(
            quat_mul(self.rotation, _conj(quat_mul(dy, dp))))
