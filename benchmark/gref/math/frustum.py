# Frozen copy of granite_tpu_torch/math/frustum.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""View frustum extraction and vectorized culling (numpy copy of
granite_tpu/math/frustum.py; reference: math/frustum.{hpp,cpp}).

Clip-space conventions (see math/muglm.py): -w<=x<=w, -w<=y<=w and
reverse-Z 0<=z<=w.
"""

from __future__ import annotations

import numpy as np


def extract_planes(view_proj: np.ndarray) -> np.ndarray:
    """(6, 4) planes (a,b,c,d), inside when a*x+b*y+c*z+d >= 0."""
    m = np.asarray(view_proj, dtype=np.float32)
    rows = [m[3] + m[0],   # x >= -w
            m[3] - m[0],   # x <=  w
            m[3] + m[1],   # y >= -w
            m[3] - m[1],   # y <=  w
            m[2],          # z >= 0   (reverse-Z far plane at infinity-safe)
            m[3] - m[2]]   # z <=  w  (near plane)
    planes = np.stack(rows)
    norms = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
    return planes / np.maximum(norms, 1e-30)


class Frustum:
    def __init__(self, view_proj: np.ndarray):
        self.view_proj = np.asarray(view_proj, dtype=np.float32)
        self.planes = extract_planes(view_proj)


def frustum_cull(planes, mins, maxs):
    """Vectorized AABB-vs-frustum test (positive-vertex test).

    planes: (6, 4); mins/maxs: (N, 3).  Returns (N,) bool visibility mask.
    """
    n = planes[:, :3]                                   # (6, 3)
    d = planes[:, 3]                                    # (6,)
    # Positive vertex: per-plane select max where normal >= 0 else min.
    pv = np.where(n[None, :, :] >= 0, maxs[:, None, :], mins[:, None, :])
    dist = (pv * n[None, :, :]).sum(-1) + d[None, :]     # (N, 6)
    return (dist >= 0).all(-1)
