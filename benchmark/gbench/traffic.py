"""The one pose generator: a traffic file's parameters -> the cell's pose
list, float32 (position (3,), rotation quaternion w, x, y, z (4,)).

The camera moves along a closed curve in the xz plane at "eye_height":
  p(t) = centre + (radius + sum_k a_k cos(k t + phi_k)) (cos t, sin t),
stepping either a fixed angle a frame ("step": {"angle": rad}) or a fixed
arc length a frame ("step": {"metres": m}, the list closing the loop with
steps within a thousandth of it).  It looks at a fixed point ("look":
[x, y, z]) or along the path ("look": "path", level).  The seed picks only
where on the loop the list starts, so every seed renders the same set of
poses in another order.  Resolution ("width", "height") is part of the
traffic: the user picks the swapchain size at run time.
"""

from __future__ import annotations

import numpy as np

from gref.math.muglm import look_at_quat

# Curve samples a radian when measuring arc length.
_DENSITY = 4096


def _curve(params: dict, t: np.ndarray) -> np.ndarray:
    cx, cz = params["centre"]
    r = np.full_like(t, float(params["radius"]))
    for k, a, phi in params.get("harmonics", []):
        r = r + a * np.cos(k * t + phi)
    return np.stack([cx + r * np.cos(t), np.full_like(t, params["eye_height"]),
                     cz + r * np.sin(t)], axis=-1)


def loop_angles(params: dict) -> np.ndarray:
    """The curve parameter of every pose of one loop, from t = 0."""
    step = params["step"]
    if "angle" in step:
        n = int(np.ceil(2 * np.pi / float(step["angle"]) - 1e-9))
        return np.arange(n) * float(step["angle"])
    t = np.linspace(0.0, 2 * np.pi, int(2 * np.pi * _DENSITY) + 1)
    p = _curve(params, t)
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(p, axis=0),
                                                        axis=1))])
    n = max(int(round(s[-1] / float(step["metres"]))), 3)
    return np.interp(np.arange(n) * (s[-1] / n), s, t)


def poses(params: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (positions (N, 3) f32, rotations (N, 4) f32), one loop starting
    at the seed's place on it."""
    t = loop_angles(params)
    n = len(t)
    start = int(np.random.default_rng(int(seed) & (2**63 - 1))
                .integers(0, n))
    t = np.roll(t, -start)
    pos = _curve(params, t).astype(np.float32)
    look = params["look"]
    rots = []
    for i in range(n):
        if look == "path":
            d = _curve(params, np.array([t[i] + 1e-4]))[0] - \
                _curve(params, np.array([t[i] - 1e-4]))[0]
            d[1] = 0.0
        else:
            d = np.asarray(look, np.float64) - pos[i]
        rots.append(look_at_quat(np.asarray(d, np.float32),
                                 (0.0, 1.0, 0.0)))
    return pos, np.asarray(rots, np.float32)
