"""Volumetric diffuse GI: ambient-cube probe grids (port of
granite_tpu/renderer/volumetric_diffuse.py; reference
renderer/lights/volumetric_diffuse.{hpp,cpp}, lights/volumetric_diffuse.h
and the volumetric_hemisphere_integral / volumetric_light_compute_fallback
compute shaders).

Each volume is an (X, Y, Z) grid of probes over a node-transformed unit
box; every probe stores an ambient cube (6 RGB irradiance values, one per
axis direction), as a dense (6, Z, Y, X, 3) tensor.  Shading samples the
grid trilinearly (the 8 corners packed as channels: one gather a face),
blends the three axis faces by normal^2 with sign-selected faces, weights
volumes by a guard-band term and normalizes by the total weight with a
0.01-weighted sky fallback (volumetric_diffuse.h:87-153).  The bake
renders 6 small cube faces a probe through the engine's own surface and
shade route (the viewer's _bake_diffuse_volumes) and integrates them with
the cubemap-texel solid angle 4 / (res^2 l^3), cosine-weighted, / pi.
Plain PyTorch: the reference is jnp, not a Pallas kernel.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.hdr import clamped_floor
from ..ops.pbr import PI

# Cube-face basis (+X, -X, +Y, -Y, +Z, -Z with the Vulkan cubemap du/dv).
FACE_DIRS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                      [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
FACE_DU = np.array([[0, 0, -1], [0, 0, 1], [1, 0, 0],
                    [1, 0, 0], [1, 0, 0], [-1, 0, 0]], np.float32)
FACE_DV = np.array([[0, -1, 0], [0, -1, 0], [0, 0, 1],
                    [0, 0, -1], [0, -1, 0], [0, -1, 0]], np.float32)


@dataclass
class DiffuseVolume:
    """One probe-grid volume (VolumetricDiffuseLightComponent)."""
    world_to_tex: np.ndarray     # (3, 4) world -> [0,1]^3
    tex_to_world: np.ndarray     # (3, 4)
    resolution: tuple            # (X, Y, Z)
    ambient: torch.Tensor        # (6, Z, Y, X, 3) ambient-cube grid
    packed: torch.Tensor         # (6, Z, Y, X, 24) the 8 corners
    guard_band_factor: float = 0.9
    guard_band_sharpen: float = 16.0


def volume_transforms(node_world: np.ndarray):
    """world_to_tex / tex_to_world of a unit box [-0.5, 0.5]^3 node:
    tex = local + 0.5."""
    m = np.asarray(node_world, np.float64)
    shift = np.eye(4)
    shift[:3, 3] = -0.5
    t2w = (m @ shift)[:3].astype(np.float32)
    w2t = np.linalg.inv(m @ shift)[:3].astype(np.float32)
    return w2t, t2w


def probe_positions(t2w: np.ndarray, resolution) -> np.ndarray:
    """(Z, Y, X, 3) world probe positions at texel centers."""
    rx, ry, rz = resolution
    gx = (np.arange(rx) + 0.5) / rx
    gy = (np.arange(ry) + 0.5) / ry
    gz = (np.arange(rz) + 0.5) / rz
    zz, yy, xx = np.meshgrid(gz, gy, gx, indexing="ij")
    tex = np.stack([xx, yy, zz, np.ones_like(xx)], axis=-1)
    return (tex @ t2w.T).astype(np.float32)


def face_solid_angle_weights(res: int):
    """Per-texel cube-face directions (6, R, R, 3), unnormalized, and the
    texel solid angle 4 / (res^2 l^3) (R, R) (face-independent)."""
    uv = (np.arange(res, dtype=np.float32) + 0.5) / res * 2.0 - 1.0
    cu, cv = np.meshgrid(uv, uv, indexing="xy")
    dirs = (FACE_DIRS[:, None, None] + FACE_DU[:, None, None] * cu[..., None]
            + FACE_DV[:, None, None] * cv[..., None])
    inv_l = 1.0 / np.sqrt(1.0 + cu * cu + cv * cv)
    area = (4.0 / (res * res)) * inv_l ** 3
    return dirs.astype(np.float32), area.astype(np.float32)


def ambient_cube_integral(face_colors: torch.Tensor, dirs=None, area=None):
    """Rendered cube faces (..., 6, R, R, 3) linear HDR -> ambient cubes
    (..., 6, 3): for each axis direction N_f, sum(color * clamp(dot(N_f,
    n), 0) * A) / pi over every cube texel."""
    res = face_colors.shape[-3]
    if dirs is None:
        dirs, area = face_solid_angle_weights(res)
    dev = face_colors.device
    dirs = torch.as_tensor(dirs, device=dev)
    inv_l = 1.0 / torch.sqrt((dirs * dirs).sum(-1, keepdim=True))
    n = dirs * inv_l                                     # (6, R, R, 3)
    area = torch.as_tensor(area, device=dev)             # (R, R)
    cube = []
    for f in range(6):
        cosw = (n @ torch.as_tensor(FACE_DIRS[f], device=dev)).clamp_min(0.0)
        w = cosw * area[None]                            # (6, R, R)
        cube.append((face_colors * w[..., None]).sum((-4, -3, -2)) / PI)
    return torch.stack(cube, dim=-2)


def oct_pack_grid(ambient: torch.Tensor) -> torch.Tensor:
    """(6, Z, Y, X, 3) -> (6, Z, Y, X, 24): the 8 trilinear corner texels
    as channels [c000 c100 c010 c110 c001 c101 c011 c111] (x fastest),
    edge-clamped, so one gather returns a pixel's footprint."""
    a = ambient
    p = torch.cat([a, a[:, -1:]], 1)
    p = torch.cat([p, p[:, :, -1:]], 2)
    p = torch.cat([p, p[:, :, :, -1:]], 3)
    z, y, x = a.shape[1:4]
    return torch.cat([p[:, dz:dz + z, dy:dy + y, dx:dx + x]
                      for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                     dim=-1)


def _trilerp_packed(packed_face, lx, ly, lz, resolution):
    """Trilinear fetch from one packed face grid (Z, Y, X, 24) at texture
    coords in [0, 1] (texel centers, clamp to edge): one gather a pixel."""
    rx, ry, rz = resolution
    x = lx * rx - 0.5
    y = ly * ry - 0.5
    z = lz * rz - 0.5
    x0 = clamped_floor(x, rx - 1)
    y0 = clamped_floor(y, ry - 1)
    z0 = clamped_floor(z, rz - 1)
    fx = (x - x0).clamp(0.0, 1.0)[..., None, None, None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None, None]
    fz = (z - z0).clamp(0.0, 1.0)[..., None]
    oct = packed_face[z0.long(), y0.long(), x0.long()]      # (..., 24)
    c = oct.reshape(oct.shape[:-1] + (2, 2, 2, 3))          # dz, dy, dx
    cx = c[..., 0, :] * (1 - fx) + c[..., 1, :] * fx
    cy = cx[..., 0, :] * (1 - fy) + cx[..., 1, :] * fy
    return cy[..., 0, :] * (1 - fz) + cy[..., 1, :] * fz


def sample_volumetric_diffuse(volumes, world_pos, normal, fallback_cube):
    """compute_volumetric_diffuse: guard-band-weighted ambient-cube
    irradiance of every volume with the 0.01-weight sky fallback,
    normalized by the total weight -> (..., 3) (the lambertian 1/pi is in
    the probes).  fallback_cube: (6, 3) sky ambient cube."""
    n2 = normal * normal
    neg = (normal < 0.0).long()
    fb = fallback_cube
    result = (n2[..., 0:1] * fb[neg[..., 0]]
              + n2[..., 1:2] * fb[neg[..., 1] + 2]
              + n2[..., 2:3] * fb[neg[..., 2] + 4]) * 0.01
    weight = torch.full(world_pos.shape[:-1], 0.01, dtype=torch.float32,
                        device=world_pos.device)
    wp1 = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    for vol in volumes:
        w2t = torch.as_tensor(vol.world_to_tex, device=world_pos.device)
        local = wp1 @ w2t.T                               # (..., 3)
        dist = (local - 0.5).abs().amax(-1)
        w = ((0.5 - vol.guard_band_factor * dist)
             * vol.guard_band_sharpen).clamp(0.0, 1.0)
        lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
        contrib = torch.zeros_like(result)
        for axis in range(3):
            pos_f = _trilerp_packed(vol.packed[2 * axis], lx, ly, lz,
                                    vol.resolution)
            neg_f = _trilerp_packed(vol.packed[2 * axis + 1], lx, ly, lz,
                                    vol.resolution)
            face_val = torch.where((normal[..., axis] < 0.0)[..., None],
                                   neg_f, pos_f)
            contrib = contrib + n2[..., axis:axis + 1] * face_val
        result = result + contrib * w[..., None]
        weight = weight + w
    return result / weight.clamp_min(1e-4)[..., None]


def fallback_cube_from_sky(sample_sky_fn, res: int = 16,
                           device="cpu") -> torch.Tensor:
    """The sky's ambient cube (6, 3) (update_fallback_volume).
    sample_sky_fn(dirs (N, 3) tensor) -> (N, 3) radiance."""
    dirs, area = face_solid_angle_weights(res)
    nrm = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    colors = sample_sky_fn(torch.as_tensor(nrm.reshape(-1, 3), device=device))
    return ambient_cube_integral(colors.reshape(6, res, res, 3), dirs, area)


def bake_volume(render_face_fn, node_world, resolution, face_res: int = 16,
                guard_band_factor: float = 0.9,
                guard_band_sharpen: float = 16.0) -> DiffuseVolume:
    """Bake a DiffuseVolume by rendering the scene from every probe:
    render_face_fn(pos (3,), face) -> (face_res, face_res, 3) linear HDR
    tensor.  Every face is rendered first, then all the probes' ambient
    cubes are integrated in one pass on the faces' device."""
    w2t, t2w = volume_transforms(node_world)
    pos = probe_positions(t2w, resolution)               # (Z, Y, X, 3)
    rx, ry, rz = resolution
    dirs, area = face_solid_angle_weights(face_res)
    faces = torch.stack([
        torch.stack([render_face_fn(pos[z, y, x], f) for f in range(6)])
        for z, y, x in itertools.product(range(rz), range(ry), range(rx))])
    cubes = ambient_cube_integral(faces, dirs, area)     # (P, 6, 3)
    ambient = cubes.reshape(rz, ry, rx, 6, 3).permute(3, 0, 1, 2, 4) \
        .contiguous()
    return DiffuseVolume(world_to_tex=w2t, tex_to_world=t2w,
                         resolution=tuple(resolution), ambient=ambient,
                         packed=oct_pack_grid(ambient),
                         guard_band_factor=guard_band_factor,
                         guard_band_sharpen=guard_band_sharpen)
