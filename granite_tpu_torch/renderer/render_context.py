"""Per-view camera matrices (copy of granite_tpu/renderer/render_context.py,
which cannot be imported without jax: its package __init__ imports the
JAX renderer)."""

from __future__ import annotations

import numpy as np

from ..math.frustum import Frustum


class RenderContext:
    def __init__(self):
        self.view = np.eye(4, dtype=np.float32)
        self.projection = np.eye(4, dtype=np.float32)
        self.view_projection = np.eye(4, dtype=np.float32)
        self.camera_pos = np.zeros(3, np.float32)
        self.frustum: Frustum | None = None

    def set_camera(self, camera) -> None:
        self.view = camera.get_view()
        self.projection = camera.get_projection()
        self.view_projection = (self.projection @ self.view).astype(
            np.float32)
        self.camera_pos = np.asarray(camera.position, np.float32)
        self.frustum = Frustum(self.view_projection)
