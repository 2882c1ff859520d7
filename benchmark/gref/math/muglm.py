# Frozen copy of granite_tpu_torch/math/muglm.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""Math conventions of Granite's muglm (copy of granite_tpu/math/muglm.py,
the functions the port uses; reference: math/muglm/muglm.{hpp,cpp}).

muglm is a column-major GLM clone with:
  * right-handed GL view space (camera looks down -Z),
  * Vulkan clip space: Y-flip baked into the projection matrices, Z in [0,1],
  * reverse-Z projections: near plane maps to z_ndc = 1, far to 0 — depth
    test is GREATER, clear depth 0.0,
  * quaternions stored (w, x, y, z).

numpy row-major storage with `clip = P @ V @ M @ [x y z 1]^T`; muglm's
m[col][row] maps to M[row, col].  Every function returns float32 arrays
(host-side camera math).  tests/test_torch_host_copies.py holds each
function equal to its original.
"""

from __future__ import annotations

import numpy as np

INFINITE_FAR_PLANE = float("inf")


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def normalize(v):
    v = _f32(v)
    return v / np.linalg.norm(v)


def perspective(fovy: float, aspect: float, znear: float,
                zfar: float = INFINITE_FAR_PLANE) -> np.ndarray:
    """Reverse-Z, Y-flipped perspective (muglm.cpp:319-343)."""
    t = np.tan(0.5 * fovy)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    if zfar == INFINITE_FAR_PLANE:
        # z_clip = znear; z_ndc = znear / -z_eye  (reverse-Z to 0 at infinity)
        m[2, 3] = znear
    else:
        m[2, 2] = -1.0 - zfar / (znear - zfar)   # = znear / (zfar - znear)
        m[2, 3] = -(zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    m[1] *= -1.0  # Vulkan Y-flip (row 1 = muglm's "result[c].y" for all c)
    return m


def ortho(left: float, right: float, bottom: float, top: float,
          znear: float, zfar: float) -> np.ndarray:
    """Reverse-Z, Y-flipped orthographic projection (muglm.cpp:270-287)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 2] = 1.0 / (zfar - znear)
    m[2, 3] = 1.0 + znear / (zfar - znear)
    m[1] *= -1.0
    return m


def translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = _f32(v)
    return m


# ---------------------------------------------------------------------------
# Quaternions: (w, x, y, z) layout matching muglm.
# ---------------------------------------------------------------------------

def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = normalize(axis)
    s = np.sin(0.5 * angle)
    return _f32([np.cos(0.5 * angle), axis[0] * s, axis[1] * s, axis[2] * s])


def quat_mul(a, b) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return _f32([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_normalize(q) -> np.ndarray:
    q = _f32(q)
    return q / np.linalg.norm(q)


def quat_rotate(q, v) -> np.ndarray:
    """Rotate vector v by quaternion q."""
    w, x, y, z = q
    u = _f32([x, y, z])
    v = _f32(v)
    return 2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v \
        + 2.0 * w * np.cross(u, v)


def quat_slerp(a, b, t: float) -> np.ndarray:
    a = _f32(a)
    b = _f32(b)
    d = float(np.dot(a, b))
    if d < 0.0:
        b = -b
        d = -d
    if d > 0.9995:
        return quat_normalize(a + t * (b - a))
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    return _f32((np.sin((1 - t) * theta) * a + np.sin(t * theta) * b)
                / np.sin(theta))


def mat3_cast(q) -> np.ndarray:
    """Quaternion to rotation matrix (muglm.cpp:30-57)."""
    w, x, y, z = quat_normalize(q)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _f32([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ])


def mat4_cast(q) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = mat3_cast(q)
    return m


def look_at_quat(direction, up) -> np.ndarray:
    """Quaternion rotating `direction` onto -Z with `up` onto +Y
    (math/transforms.cpp:168-178).  Built from the orthonormal basis."""
    f = normalize(direction)
    r = normalize(np.cross(f, _f32(up)))
    u = np.cross(r, f)
    # Rotation matrix with rows r, u, -f maps world to view; convert to quat.
    m = np.stack([r, u, -f])
    return _quat_from_mat3(m)


def _quat_from_mat3(m) -> np.ndarray:
    t = m[0, 0] + m[1, 1] + m[2, 2]
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return quat_normalize([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                               (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4, dtype=np.float32)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return quat_normalize(q)


def look_at_matrix(eye, center, up) -> np.ndarray:
    """View matrix: camera at `eye` looking at `center` (RH, -Z forward)."""
    f = normalize(_f32(center) - _f32(eye))
    r = normalize(np.cross(f, _f32(up)))
    u = np.cross(r, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = r
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ _f32(eye)
    return m
