"""Vectorized AABB transform (copy of granite_tpu/math/aabb.py
transform_aabbs; reference: math/aabb.{hpp,cpp})."""

from __future__ import annotations

import numpy as np


def transform_aabbs(world: np.ndarray, mins: np.ndarray,
                    maxs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized AABB transform for SoA scenes.

    world: (N, 4, 4) transforms; mins/maxs: (N, 3) local bounds.
    Returns (world_mins, world_maxs), each (N, 3).  Uses the center/extent
    absolute-matrix trick (equivalent to transforming all 8 corners).
    """
    c = 0.5 * (mins + maxs)
    e = 0.5 * (maxs - mins)
    rot = world[:, :3, :3]
    wc = np.einsum("nij,nj->ni", rot, c) + world[:, :3, 3]
    we = np.einsum("nij,nj->ni", np.abs(rot), e)
    return (wc - we).astype(np.float32), (wc + we).astype(np.float32)
