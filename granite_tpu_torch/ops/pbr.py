"""PBR BRDF terms (port of granite_tpu/ops/pbr.py; reference
assets/shaders/lights/pbr.h + lighting.h).

Granite's PI = 3.1415628 and the roughness remap r*0.75+0.25 are kept
verbatim for parity.  The functions work on per-channel tensors (one
tensor per vector component), the layout of the fused shade kernel
(csrc/shade_fused.cu) whose plain version uses them.
"""

from __future__ import annotations

import torch

PI = 3.1415628  # Granite's value (pbr.h) — kept verbatim for parity.
INV_PI = 1.0 / PI


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def remap_roughness(roughness):
    """lighting.h: the BRDF's perceptual roughness remap."""
    return roughness * 0.75 + 0.25


def compute_f0(base, metallic):
    """0.04 dielectric F0 lerped to the base color by metalness."""
    return 0.04 + (base - 0.04) * metallic


def cook_torrance(n, v, l, light_color, shadow, base, metallic, rough):
    """One light's full response (lighting.h compute_lighting /
    clusterer.h per-light body).  n, v, l, light_color and base are
    (x, y, z) tuples of tensors; rough is already remapped; returns the
    (r, g, b) radiance tuple."""
    nx, ny, nz = n
    vx, vy, vz = v
    lx, ly, lz = l
    nov = dot3(nx, ny, nz, vx, vy, vz).clamp(1e-3, 1.0)
    m = rough * rough
    m2 = m * m
    r1 = rough + 1.0
    k_g = r1 * r1 * 0.125
    one_m_kg = 1.0 - k_g
    gv = nov * one_m_kg + k_g
    hx = lx + vx
    hy = ly + vy
    hz = lz + vz
    hinv = torch.rsqrt(dot3(hx, hy, hz, hx, hy, hz).clamp_min(1e-20))
    hx = hx * hinv
    hy = hy * hinv
    hz = hz * hinv
    nol = dot3(nx, ny, nz, lx, ly, lz).clamp(1e-3, 1.0)
    hov = dot3(hx, hy, hz, vx, vy, vz).clamp(1e-3, 1.0)
    t = 1.0 - hov
    t2 = t * t
    t5 = t2 * t2 * t
    noh = dot3(nx, ny, nz, hx, hy, hz).clamp(1e-4, 1.0)
    dd = (noh * m2 - noh) * noh + 1.0
    d = m2 / (PI * dd * dd)
    gl = nol * one_m_kg + k_g
    g = 0.25 / (gv * gl).clamp_min(1e-3)
    dg = d * g
    one_m_metal = 1.0 - metallic
    out = []
    for b, lc in zip(base, light_color):
        f0 = compute_f0(b, metallic)
        f = f0 + (1.0 - f0) * t5
        term = lc * (nol * shadow)
        diff = (1.0 - f) * INV_PI * b * one_m_metal
        out.append(term * (f * dg + diff))
    return tuple(out)
