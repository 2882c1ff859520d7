"""Clustered lighting tables (port of granite_tpu/ops/clusterer.py;
reference renderer/lights/clusterer + clusterer_bindless_binning.comp).

Lights are packed into a fixed-capacity table, binned into logarithmic
view-depth slices and into screen tiles; both bins are 32-bit masks
(int32 here, one word for the <= 32 lights the slice supports).  The
per-pixel light loop itself lives in kernel B4 (ops/shade_fused.py);
positional_light_color is the same light term for the fog's per-froxel
loop (ops/volumetric_fog.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.timeline_trace import upload

MIN_POINT_DIST = 0.1


class LightBuffer(NamedTuple):
    pos: torch.Tensor              # (L, 3)
    color: torch.Tensor            # (L, 3)
    inv_radius: torch.Tensor       # (L,)
    dir: torch.Tensor              # (L, 3)
    spot_scale_bias: torch.Tensor  # (L, 2)
    is_spot: torch.Tensor          # (L,)
    count: int                     # actual light count


def pack_lights(positions, colors, radii, directions=None,
                inner_cones=None, outer_cones=None, is_spot=None,
                capacity: int = 32, device="cpu") -> LightBuffer:
    """Host-side packing into the fixed-capacity light table; dead slots
    get inv_radius 1e9 so they never pass the falloff."""
    n = min(len(positions), capacity)
    pos = np.zeros((capacity, 3), np.float32)
    col = np.zeros((capacity, 3), np.float32)
    inv_r = np.full(capacity, 1e9, np.float32)
    dirs = np.tile(np.array([0, -1, 0], np.float32), (capacity, 1))
    ssb = np.zeros((capacity, 2), np.float32)
    spot = np.zeros(capacity, np.float32)
    pos[:n] = positions[:n]
    col[:n] = colors[:n]
    inv_r[:n] = 1.0 / np.maximum(np.asarray(radii[:n], np.float32), 1e-6)
    if directions is not None:
        dirs[:n] = directions[:n]
    if is_spot is not None:
        spot[:n] = np.asarray(is_spot[:n], np.float32)
        if inner_cones is not None:
            ci = np.cos(np.asarray(inner_cones[:n], np.float32))
            co = np.cos(np.asarray(outer_cones[:n], np.float32))
            scale = 1.0 / np.maximum(ci - co, 1e-4)
            ssb[:n, 0] = scale
            ssb[:n, 1] = -co * scale

    def t(a):
        return upload(a, device=device)

    return LightBuffer(t(pos), t(col), t(inv_r), t(dirs), t(ssb), t(spot), n)


def _masks_from_overlap(overlap):
    """Pack a (..., L<=32) bool into (..., 1) int32 bit masks."""
    L = overlap.shape[-1]
    if L > 32:
        raise NotImplementedError("more than 32 lights need multi-word "
                                  "masks (not in this slice)")
    word = torch.zeros(overlap.shape[:-1], dtype=torch.int32,
                       device=overlap.device)
    for i in range(L):
        word = word | (overlap[..., i].to(torch.int32) << i)
    return word[..., None]


def bin_lights_z(lights: LightBuffer, view, z_slices: int, z_near: float,
                 z_far: float):
    """Per-slice masks of lights whose view-depth range overlaps the
    logarithmic slice.  -> (z_slices, 1) int32."""
    L = lights.pos.shape[0]
    dev = lights.pos.device
    vz = -(lights.pos @ view[2, :3] + view[2, 3])
    r = 1.0 / lights.inv_radius.clamp_min(1e-12)
    z0 = (vz - r).clamp_min(z_near)
    z1 = (vz + r).clamp_min(z_near)
    log_ratio = math.log(z_far / z_near)
    s0 = torch.floor(torch.log(z0 / z_near) / log_ratio * z_slices)
    s1 = torch.ceil(torch.log(z1 / z_near) / log_ratio * z_slices)
    s0 = s0.clamp(0, z_slices - 1).to(torch.int32)
    s1 = s1.clamp(0, z_slices).to(torch.int32)
    alive = (torch.arange(L, device=dev) < lights.count) & (vz + r > z_near)
    slice_ids = torch.arange(z_slices, dtype=torch.int32, device=dev)
    overlap = (slice_ids[:, None] >= s0[None, :]) & \
        (slice_ids[:, None] < s1[None, :]) & alive[None, :]
    return _masks_from_overlap(overlap)


def bin_lights_tiles(lights: LightBuffer, view_proj, width: int,
                     height: int, tile: int = 64):
    """Screen-tile masks from each light's projected AABB corners.
    -> (ty, tx, 1) int32."""
    L = lights.pos.shape[0]
    dev = lights.pos.device
    tx = -(-width // tile)
    ty = -(-height // tile)
    r = 1.0 / lights.inv_radius.clamp_min(1e-12)
    corners = upload(np.array(
        [[(i >> k) & 1 for k in range(3)] for i in range(8)],
        np.float32) * 2 - 1, device=dev)
    pts = lights.pos[:, None, :] + corners[None] * r[:, None, None]
    h = pts @ view_proj[:3, :3].T + view_proj[:3, 3]
    w = pts @ view_proj[3, :3] + view_proj[3, 3]
    behind = w <= 1e-6
    any_behind = behind.any(dim=1)
    w_safe = torch.where(behind, torch.full_like(w, 1e-6), w)
    sx = (0.5 * h[..., 0] / w_safe + 0.5) * width
    sy = (0.5 * h[..., 1] / w_safe + 0.5) * height
    zero = torch.zeros_like(any_behind, dtype=torch.float32)
    x0 = torch.where(any_behind, zero, sx.min(dim=1).values)
    x1 = torch.where(any_behind, zero + width, sx.max(dim=1).values)
    y0 = torch.where(any_behind, zero, sy.min(dim=1).values)
    y1 = torch.where(any_behind, zero + height, sy.max(dim=1).values)
    tx0 = torch.floor(x0 / tile).clamp(0, tx - 1).to(torch.int32)
    tx1 = torch.ceil(x1 / tile).clamp(1, tx).to(torch.int32)
    ty0 = torch.floor(y0 / tile).clamp(0, ty - 1).to(torch.int32)
    ty1 = torch.ceil(y1 / tile).clamp(1, ty).to(torch.int32)
    alive = torch.arange(L, device=dev) < lights.count
    ix = torch.arange(tx, dtype=torch.int32, device=dev)
    iy = torch.arange(ty, dtype=torch.int32, device=dev)
    in_x = (ix[None, :] >= tx0[:, None]) & (ix[None, :] < tx1[:, None])
    in_y = (iy[None, :] >= ty0[:, None]) & (iy[None, :] < ty1[:, None])
    overlap = (in_y.T[:, None, :] & in_x.T[None, :, :]
               & alive[None, None, :])
    return _masks_from_overlap(overlap)


def positional_light_color(lights: LightBuffer, i: int, world_pos):
    """Light i's radiance at world_pos (compute_point_color /
    compute_spot_color): inverse-square with a 1 - smoothstep falloff over
    the last 10% of the radius, times the squared cone ramp for a spot.
    -> (color (..., 3), direction to the light (..., 3))."""
    full = world_pos - lights.pos[i]
    dist = torch.sqrt((full * full).sum(-1).clamp_min(1e-12))
    dist = dist.clamp_min(MIN_POINT_DIST)
    ldir = -full / dist[..., None]
    x = dist * lights.inv_radius[i]
    t = ((x - 0.9) / 0.1).clamp(0.0, 1.0)
    static_falloff = 1.0 - t * t * (3.0 - 2.0 * t)
    cone = ((-ldir * lights.dir[i]).sum(-1) * lights.spot_scale_bias[i, 0]
            + lights.spot_scale_bias[i, 1]).clamp(0.0, 1.0)
    cone = cone * cone
    falloff = torch.where(lights.is_spot[i] > 0.5, cone,
                          torch.ones_like(cone)) * static_falloff
    color = lights.color[i] * (falloff / (dist * dist))[..., None]
    return color, ldir
