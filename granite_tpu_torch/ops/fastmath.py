"""Polynomial transcendental approximations (port of
granite_tpu/ops/fastmath.py).  The polynomials are kept verbatim: the
procedural sky bake and the per-pixel equirect mapping must agree with
the reference to the last bit where they can.

  fast_atan2: max abs error ~1.2e-4 rad
  fast_acos:  max abs error ~1e-4 rad
  pow07:      x^0.7 on [0,1], max abs error ~1.8e-3
"""

from __future__ import annotations

import math

import numpy as np
import torch


def fast_atan(x):
    """atan on [-1, 1] via a degree-9 odd minimax polynomial."""
    x2 = x * x
    return x * (0.99997726
                + x2 * (-0.33262347
                        + x2 * (0.19354346
                                + x2 * (-0.11643287
                                        + x2 * (0.05265332
                                                + x2 * -0.01172120)))))


def fast_atan2(y, x):
    """atan2 via octant reduction + fast_atan (jnp.arctan2 quadrants)."""
    ax = x.abs()
    ay = y.abs()
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.where(swap, ay, ax)
    t = num / den.clamp_min(1e-30)
    r = fast_atan(t)
    r = torch.where(swap, 0.5 * math.pi - r, r)
    r = torch.where(x < 0, math.pi - r, r)
    return torch.where(y < 0, -r, r)


def fast_acos(x):
    """acos via the |x|-sqrt expansion (Abramowitz-Stegun 4.4.45)."""
    xa = x.abs().clamp(0.0, 1.0)
    p = (1.5707288
         + xa * (-0.2121144
                 + xa * (0.0742610
                         + xa * -0.0187293)))
    r = p * torch.sqrt(1.0 - xa)
    return torch.where(x < 0, math.pi - r, r)


def pow07(x):
    """x^0.7 on [0, 1] = s * s^0.4 with s = sqrt(x), degree-4 fit in s."""
    s = torch.sqrt(x.clamp(0.0, 1.0))
    p = (0.22317565 + s * (1.94874432
                           + s * (-2.76040261
                                  + s * (2.4335581 + s * -0.84682995))))
    return s * p


def pow07_np(x: np.ndarray) -> np.ndarray:
    """pow07 on a numpy array (load-time bakes), same arithmetic in the
    array's own precision."""
    return pow07(torch.from_numpy(np.asarray(x))).numpy()


def equirect_uv(x, y, z):
    """Direction -> equirect (u, v): u = azimuth/2pi from +X toward +Z,
    v = polar/pi from +Y."""
    n = torch.sqrt((x * x + y * y + z * z).clamp_min(1e-20))
    theta = fast_acos((y / n).clamp(-1.0, 1.0))
    phi = fast_atan2(z, x)
    u = torch.where(phi < 0, phi + 2 * math.pi, phi) / (2 * math.pi)
    return u, theta / math.pi
