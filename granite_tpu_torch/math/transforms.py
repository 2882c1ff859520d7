"""Batched TRS composition and decomposition (copy of
granite_tpu/math/transforms.py compose_trs_batch and decompose_trs;
reference: math/transforms.{hpp,cpp})."""

from __future__ import annotations

import numpy as np

from .muglm import _quat_from_mat3, quat_normalize


def compose_trs_batch(t: np.ndarray, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(N,3),(N,4 wxyz),(N,3) -> (N,4,4) local matrices, fully vectorized."""
    r = r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-30)
    w, x, y, z = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rot = np.empty((len(r), 3, 3), dtype=np.float32)
    rot[:, 0, 0] = 1 - 2 * (yy + zz)
    rot[:, 0, 1] = 2 * (xy - wz)
    rot[:, 0, 2] = 2 * (xz + wy)
    rot[:, 1, 0] = 2 * (xy + wz)
    rot[:, 1, 1] = 1 - 2 * (xx + zz)
    rot[:, 1, 2] = 2 * (yz - wx)
    rot[:, 2, 0] = 2 * (xz - wy)
    rot[:, 2, 1] = 2 * (yz + wx)
    rot[:, 2, 2] = 1 - 2 * (xx + yy)
    m = np.zeros((len(r), 4, 4), dtype=np.float32)
    m[:, :3, :3] = rot * s[:, None, :]
    m[:, :3, 3] = t
    m[:, 3, 3] = 1.0
    return m


def decompose_trs(m: np.ndarray):
    """Matrix -> (translation, quat wxyz, scale); assumes no shear."""
    t = m[:3, 3].copy()
    basis = m[:3, :3]
    s = np.linalg.norm(basis, axis=0)
    if np.linalg.det(basis) < 0:
        s[0] = -s[0]
    rot = basis / s[None, :]
    return t.astype(np.float32), quat_normalize(_quat_from_mat3(rot)), \
        s.astype(np.float32)
