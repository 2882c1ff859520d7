"""Screen-space ambient occlusion (port of granite_tpu/ops/ssao.py;
reference renderer/post/ssao.cpp, the `ssao` knob).

"CACAO-lite": a horizon estimator over 16 fixed-offset taps (two rings
of 8) on the half-resolution linear depth, range-checked, then a 3x3 box
blur and a bilinear upsample to full size.  The AO plane feeds kernel B4
(`has_ao`).  Plain PyTorch: the reference is jnp, not a Pallas kernel.
"""

from __future__ import annotations

import numpy as np

from .hdr import resize_bilinear, shift

RADIUS_WORLD = 0.5      # depth gap past which a tap stops occluding

# 16-tap spiral (two rings of 8), in half-res pixel units.
_TAPS = []
for _ring, _radius in ((0, 2), (1, 5)):
    for _k in range(8):
        _a = 2.0 * np.pi * (_k + 0.5 * _ring) / 8.0
        _TAPS.append((int(round(_radius * np.sin(_a))),
                      int(round(_radius * np.cos(_a)))))


def linearize_reverse_z(depth, z_near: float):
    """Reverse-Z infinite-far NDC depth -> positive view depth
    (z_ndc = z_near / view_z); the background maps to a huge depth."""
    return z_near / depth.clamp_min(1e-8)


def ssao(depth, z_near: float, proj_scale: float):
    """(H, W) reverse-Z depth -> (ceil(H/2), ceil(W/2)) AO factor in [0, 1].

    proj_scale: half-res pixels per world unit at view depth 1.  Each tap
    occludes by how far the neighbour rises above the centre, faded to 0
    where the depth gap passes RADIUS_WORLD."""
    vz = linearize_reverse_z(depth[::2, ::2], z_near)
    occl = 0.0
    total = 0.0
    for dy, dx in _TAPS:
        nvz = shift(vz, dy, dx)
        dist_px = float(np.hypot(dx, dy))
        lateral = dist_px * vz / max(proj_scale, 1e-6)
        dz = vz - nvz                      # > 0: the neighbour is closer
        a = (dz / lateral.clamp_min(1e-6)).clamp(0.0, 1.0)
        rc = (1.0 - dz.abs() / RADIUS_WORLD).clamp(0.0, 1.0)
        w = 1.0 / (1.0 + 0.25 * dist_px)
        occl = occl + w * a * rc
        total = total + w
    ao = (1.0 - occl / total).clamp(0.0, 1.0)
    acc = ao
    cnt = 1.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                acc = acc + shift(ao, dy, dx)
                cnt += 1.0
    return acc / cnt


def upsample_ao(ao_half, height: int, width: int):
    """Bilinear half -> full upsample."""
    return resize_bilinear(ao_half[..., None], height, width)[..., 0]
