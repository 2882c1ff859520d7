"""Volumetric decals (port of granite_tpu/ops/decals.py).

Reference: renderer/lights/decal_volume.{hpp,cpp} (a decal is a unit box
[-0.5, 0.5]^3 with a texture) + assets/shaders/lights/volumetric_decal.h
apply_volumetric_decals: pixels whose world position maps inside a
decal's box sample its texture at uvw.xy + 0.5 and mix the sample into
base_color by decal alpha, in decal index order.

As in the JAX package, the cluster bitmasks are replaced by host-side
frustum culling plus a dense in-range test of every pixel against every
visible decal, and the ordered blend is decomposed into `layers` overlap
layers, each one clamp-addressed fetch from the stacked quad-packed
decal strips.  Layer k applies the k-th smallest in-range decal index,
which reproduces the sequential mix exactly for pixels under at most
`layers` decals.  Plain torch: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .texture import WRAP_CLAMP, build_packed_strip_np, sample_packed_level


class DecalBuffer(NamedTuple):
    world_to_tex: torch.Tensor   # (D, 3, 4) rows of the world->local map
    tex_id: torch.Tensor         # (D,) int32 index into the strip array
    count: torch.Tensor          # () int32 live decals


def pack_decals(world_transforms, tex_ids, capacity: int = 16,
                device="cpu") -> DecalBuffer:
    """Host-side packing to the fixed-capacity decal table.

    world_transforms: (D, 4, 4) node world matrices (local unit box ->
    world); world_to_tex is their inverse's first three rows
    (volumetric_decal.h:50-52).  Dead slots translate to +1e9 so the
    |uvw| < 0.5 test can never pass."""
    d = min(len(world_transforms), capacity)
    w2t = np.zeros((capacity, 3, 4), np.float32)
    w2t[:, :, 3] = 1e9
    tid = np.zeros(capacity, np.int32)
    for i in range(d):
        inv = np.linalg.inv(np.asarray(world_transforms[i], np.float64))
        w2t[i] = inv[:3].astype(np.float32)
        tid[i] = tex_ids[i]
    return DecalBuffer(torch.as_tensor(w2t, device=device),
                       torch.as_tensor(tid, device=device),
                       torch.tensor(d, dtype=torch.int32, device=device))


def build_decal_strips(images_rgba) -> np.ndarray:
    """Stack decal images (each (S, S, 4) float linear) into the
    quad-packed clamp-wrap strip array apply_decals samples."""
    return np.stack([build_packed_strip_np(img, wrap=WRAP_CLAMP)
                     for img in images_rgba])


def decal_world_aabbs(world_transforms):
    """World AABBs of the unit boxes (host side, for frustum culling)."""
    corners = np.array([[(i >> k) & 1 for k in range(3)]
                        for i in range(8)], np.float32) - 0.5   # (8, 3)
    mins, maxs = [], []
    for m in world_transforms:
        m = np.asarray(m, np.float32)
        pts = corners @ m[:3, :3].T + m[:3, 3]
        mins.append(pts.min(axis=0))
        maxs.append(pts.max(axis=0))
    return np.asarray(mins, np.float32), np.asarray(maxs, np.float32)


def _homogeneous(world_pos):
    return torch.cat([world_pos, torch.ones_like(world_pos[..., :1])],
                     dim=-1)


def apply_decals(base_color, alpha, world_pos, decals: DecalBuffer,
                 strips, layers: int = 2):
    """Blend in-range decal samples into (base_color, alpha).

    base_color: (..., 3); alpha: (...,); world_pos: (..., 3).
    strips: (N, HS-1, S, 16) quad-packed clamp strips (RGBA).
    Returns (base_color, alpha) with decals mixed in index order
    (mix(base, decal, decal.a), volumetric_decal.h:65)."""
    D = decals.world_to_tex.shape[0]
    # (..., D, 3): uvw of every pixel in every decal's texture space.
    uvw = torch.einsum("...j,dij->...di", _homogeneous(world_pos),
                       decals.world_to_tex)
    live = torch.arange(D, device=uvw.device) < decals.count
    in_range = (uvw.abs() < 0.5).all(-1) & live           # (..., D)
    # Ordered overlap layers: layer k holds each pixel's k-th smallest
    # in-range decal index (one-hot select).
    order = torch.cumsum(in_range.to(torch.int32), dim=-1)
    rgba = torch.cat([base_color, alpha[..., None]], dim=-1)
    for k in range(layers):
        sel = in_range & (order == k + 1)                 # (..., D)
        hit = sel.any(-1)
        sel_f = sel.to(torch.float32)[..., None]
        uv = (uvw[..., :2] * sel_f).sum(-2) + 0.5
        tid = (decals.tex_id * sel).sum(-1)
        tex = sample_packed_level(strips, tid, uv[..., 0], uv[..., 1], 0,
                                  4, wrap=WRAP_CLAMP)
        a = torch.where(hit, tex[..., 3], 0.0)[..., None]
        rgba = rgba * (1.0 - a) + tex * a
    return rgba[..., :3], rgba[..., 3]


def builtin_decal_image(size: int = 128) -> np.ndarray:
    """Procedural stand-in for builtin://textures/decal.png
    (decal_volume.cpp:32): a soft dark radial splat with a ring,
    (S, S, 4) float linear, alpha feathered to 0 at the border so the
    clamp sampler never smears the edge."""
    c = (np.arange(size, dtype=np.float32) + 0.5) / size - 0.5
    r = np.sqrt(c[None, :] ** 2 + c[:, None] ** 2) * 2.0   # 0..~1.4
    splat = np.clip(1.0 - r, 0.0, 1.0) ** 1.5
    ring = np.exp(-((r - 0.72) / 0.08) ** 2) * 0.6
    a = np.clip(splat * 0.85 + ring, 0.0, 1.0)
    rgb = np.stack([0.08 + 0.25 * ring, 0.05 + 0.1 * ring,
                    0.04 + 0.05 * ring], axis=-1)
    return np.concatenate([rgb, a[..., None]], axis=-1).astype(np.float32)


def apply_decals_reference(base_color, alpha, world_pos,
                           decals: DecalBuffer, strips):
    """Sequential loop over every decal slot, one fetch a decal: the
    literal volumetric_decal.h order, which the tests hold the layered
    path against."""
    D = decals.world_to_tex.shape[0]
    live = torch.arange(D, device=world_pos.device) < decals.count
    rgba = torch.cat([base_color, alpha[..., None]], dim=-1)
    wp1 = _homogeneous(world_pos)
    for i in range(D):
        uvw = wp1 @ decals.world_to_tex[i].T                # (..., 3)
        in_range = (uvw.abs() < 0.5).all(-1) & live[i]
        uv = uvw[..., :2] + 0.5
        tex = sample_packed_level(strips, decals.tex_id[i], uv[..., 0],
                                  uv[..., 1], 0, 4, wrap=WRAP_CLAMP)
        a = torch.where(in_range, tex[..., 3], 0.0)[..., None]
        rgba = rgba * (1.0 - a) + tex * a
    return rgba[..., :3], rgba[..., 3]
