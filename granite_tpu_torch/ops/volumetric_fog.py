"""Volumetric (froxel) fog (port of granite_tpu/ops/volumetric_fog.py;
reference renderer/lights/volumetric_fog + the fog_light_density and
fog_accumulate compute shaders).

  * slice mapping: world_z = exp2(tz / s) - 1 with
    s = 1 / log2(1 + z_range);
  * per-froxel albedo = density_mod * slice_extent(z) * length_mod *
    density: the uniform 0.1, or with fog regions (FOG_REGIONS) the sum
    over unit-box regions of an edge fade times the region's optional
    density grid;
  * in-scatter: the sun (through the 2x2 PCF shadow term) and every
    positional light, each with the phase 0.55 - 0.45 * dot(view, L);
  * accumulation: a 17-tap edge-clamped smoothing, then the scattering
    recurrence as two prefix sums over depth.
Default grid 160 x 92 x 64, z range 80.  Plain PyTorch: the reference is
jnp, not a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .clusterer import positional_light_color
from .hdr import clamped_floor, shift, uv_grid
from .shadow import sample_directional_shadow

DEFAULT_W, DEFAULT_H, DEFAULT_D = 160, 92, 64
Z_RANGE = 80.0
DENSITY_MOD = 0.5
INSCATTER_MOD = 0.25
FOG_DENSITY = 0.1


def slice_z_log2_scale(z_range: float) -> float:
    return 1.0 / np.log2(1.0 + z_range)


def texture_z_to_world(tz, s):
    return torch.exp2(tz / s) - 1.0


def world_to_texture_z(world_z, s):
    return torch.log2(1.0 + world_z.clamp_min(0.0)) * s


def _trilerp3_clamp(vol, local):
    """Trilinear sample of a (Dz, Hy, Wx) density grid at local [0,1]^3
    coords (LinearClampSampler semantics)."""
    dz, hy, wx = vol.shape
    x = (local[..., 0] * wx - 0.5).clamp(0, wx - 1)
    y = (local[..., 1] * hy - 0.5).clamp(0, hy - 1)
    z = (local[..., 2] * dz - 0.5).clamp(0, dz - 1)
    x0f, y0f, z0f = clamped_floor(x, wx - 1), clamped_floor(y, hy - 1), \
        clamped_floor(z, dz - 1)
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    x1 = (x0 + 1).clamp_max(wx - 1)
    y1 = (y0 + 1).clamp_max(hy - 1)
    z1 = (z0 + 1).clamp_max(dz - 1)
    fx, fy, fz = x - x0f, y - y0f, z - z0f
    cx0 = (vol[z0, y0, x0] * (1 - fx) + vol[z0, y0, x1] * fx,
           vol[z0, y1, x0] * (1 - fx) + vol[z0, y1, x1] * fx)
    cx1 = (vol[z1, y0, x0] * (1 - fx) + vol[z1, y0, x1] * fx,
           vol[z1, y1, x0] * (1 - fx) + vol[z1, y1, x1] * fx)
    cy0 = cx0[0] * (1 - fy) + cx0[1] * fy
    cy1 = cx1[0] * (1 - fy) + cx1[1] * fy
    return cy0 * (1 - fz) + cy1 * fz


def region_fog_density(pos, regions):
    """compute_fog_density with FOG_REGIONS (fog_light_density.comp
    :20-60): the sum over unit-box regions (world_to_tex (3, 4), density
    grid (D, H, W) or None) of fade(local) * the grid's sample; the fade
    ramps to 0 over the outer 1/16 of the box (8 * (0.5 - max|local -
    0.5|))."""
    wp1 = torch.cat([pos, torch.ones_like(pos[..., :1])], dim=-1)
    density = torch.zeros(pos.shape[:-1], dtype=torch.float32,
                          device=pos.device)
    for w2t, vol in regions:
        local = wp1 @ torch.as_tensor(w2t, dtype=torch.float32,
                                      device=pos.device).T
        xmax = (local - 0.5).abs().amax(-1)
        fade = (8.0 * (0.5 - xmax)).clamp(0.0, 1.0)
        if vol is not None:
            fade = fade * _trilerp3_clamp(torch.as_tensor(
                vol, dtype=torch.float32, device=pos.device), local)
        density = density + fade
    return density


def fog_light_density(inv_view_proj, proj, camera_pos, sun_dir, sun_color,
                      shadow_map=None, shadow_uv_mat=None, lights=None,
                      grid=(DEFAULT_D, DEFAULT_H, DEFAULT_W), regions=None):
    """-> (D, H, W, 4) light-density volume: rgb = in-scattered light,
    a = extinction albedo.  proj: the host (4, 4) camera projection;
    shadow_map: an (S, S) sun depth map or None; regions: a list of
    (world_to_tex, density grid or None) fog regions, or None for the
    uniform density."""
    D, H, W = grid
    dev = inv_view_proj.device
    s = slice_z_log2_scale(Z_RANGE)
    tz = (torch.arange(D, dtype=torch.float32, device=dev) + 0.5) / D
    world_z = texture_z_to_world(tz, s)                        # (D,)
    edges = texture_z_to_world(
        torch.arange(D + 1, dtype=torch.float32, device=dev) / D, s)
    extents = edges[1:] - edges[:-1]                           # (D,)

    uu, vv = uv_grid(H, W, dev)
    ndc_x = 2 * uu - 1
    ndc_y = 2 * vv - 1
    # View depth d -> NDC z through the projection rows:
    # ndc_z = (m22 * (-d) + m23) / d.
    m22, m23 = float(proj[2, 2]), float(proj[2, 3])
    clip_z = (-m22 * world_z + m23) / world_z.clamp_min(1e-6)  # (D,)
    ndc = torch.stack([
        ndc_x.expand(D, H, W), ndc_y.expand(D, H, W),
        clip_z[:, None, None].expand(D, H, W),
        torch.ones((D, H, W), dtype=torch.float32, device=dev)], dim=-1)
    wp = ndc @ inv_view_proj.T
    w = wp[..., 3:4]
    pos = wp[..., :3] / torch.where(w.abs() < 1e-12,
                                    torch.full_like(w, 1e-12), w)

    view_dir = pos - camera_pos
    view_dir = view_dir / torch.sqrt(
        (view_dir * view_dir).sum(-1, keepdim=True).clamp_min(1e-12))
    phase = 0.55 - 0.45 * (view_dir * sun_dir).sum(-1)
    if shadow_map is not None:
        phase = phase * sample_directional_shadow(shadow_map, shadow_uv_mat,
                                                  pos)
    light = sun_color * phase[..., None]

    if lights is not None:
        # Every positional light for every froxel; the slots past
        # lights.count are dead (zero colour) and are skipped.
        acc = torch.zeros_like(light)
        for i in range(lights.count):
            color, ld = positional_light_color(lights, i, pos)
            ph = 0.55 - 0.45 * (view_dir * ld).sum(-1)
            acc = acc + color * ph[..., None]
        light = light + acc

    xs = 1.0 / abs(float(proj[0, 0]))
    ys = 1.0 / abs(float(proj[1, 1]))
    length_mod = torch.sqrt(1.0 + (ndc_x * xs) ** 2 + (ndc_y * ys) ** 2)
    if regions is not None:
        dens = region_fog_density(pos, regions)               # (D, H, W)
    else:
        dens = torch.full((D, H, W), FOG_DENSITY, dtype=torch.float32,
                          device=dev)
    albedo = DENSITY_MOD * dens * extents[:, None, None] * length_mod[None]
    return torch.cat([light * INSCATTER_MOD, albedo[..., None]], dim=-1)


def _shift3(vol, dy: int, dx: int, dz: int):
    """Edge-clamped shift of a (D, H, W, C) volume (z = slice axis)."""
    vol = shift(vol, dz, dy)
    return shift(vol.movedim(2, 0), dx, 0).movedim(0, 2) if dx else vol


_TAP_W = [1.0 / (1.375 * k) for k in (4.0, 8.0, 16.0, 32.0)]
# (x, y, z, weight) of the 17-tap smoothing (fog_accumulate.comp).
_TAPS = [(0, 0, 0, _TAP_W[0]),
         (0, -1, -1, _TAP_W[2]), (-1, 0, -1, _TAP_W[2]),
         (1, 0, -1, _TAP_W[2]), (0, 1, -1, _TAP_W[2]),
         (-1, -1, -1, _TAP_W[3]), (1, -1, -1, _TAP_W[3]),
         (-1, 1, -1, _TAP_W[3]), (1, 1, -1, _TAP_W[3]),
         (0, -1, 0, _TAP_W[1]), (-1, 0, 0, _TAP_W[1]),
         (1, 0, 0, _TAP_W[1]), (0, 1, 0, _TAP_W[1]),
         (1, -1, 0, _TAP_W[2]), (-1, -1, 0, _TAP_W[2]),
         (-1, 1, 0, _TAP_W[2]), (1, 1, 0, _TAP_W[2])]


def fog_accumulate(light_density):
    """(D, H, W, 4) -> (D, H, W, 4) accumulated fog volume: rgb = the
    in-scatter up to the slice, a = transmittance exp2(-sum a).  The
    recurrence light += back.rgb * exp2(-front.a) * back.a; a += back.a
    is a pair of prefix sums over depth."""
    back = 0.0
    for x, y, z, w in _TAPS:
        back = back + w * _shift3(light_density, y, x, z)
    a = back[..., 3]
    a_incl = torch.cumsum(a, dim=0)
    a_excl = a_incl - a
    rgb = torch.cumsum(back[..., :3] * (a * torch.exp2(-a_excl))[..., None],
                       dim=0)
    return torch.cat([rgb, torch.exp2(-a_incl)[..., None]], dim=-1)


def apply_fog(color, world_z, fog_volume):
    """Composite fog onto a shaded frame: color * transmittance +
    in-scatter, fetched nearest in xy and linear in z.

    color: (H, W, 3); world_z: (H, W) positive view depth (background =
    large); fog_volume: (D, Hf, Wf, 4)."""
    D, Hf, Wf = fog_volume.shape[:3]
    H, W = color.shape[:2]
    dev = color.device
    s = slice_z_log2_scale(Z_RANGE)
    tz = world_to_texture_z(world_z, s) * D - 0.5
    z0f = clamped_floor(tz, D - 1)
    fz = (tz - z0f).clamp(0.0, 1.0)[..., None]
    z0 = z0f.long()
    z1 = (z0 + 1).clamp_max(D - 1)
    xi = ((torch.arange(W, device=dev) * Wf) // W).clamp(0, Wf - 1)
    yi = ((torch.arange(H, device=dev) * Hf) // H).clamp(0, Hf - 1)
    flat = fog_volume.reshape(D * Hf * Wf, 4)
    row = yi[:, None] * Wf + xi[None, :]                        # (H, W)
    f0 = flat[z0 * (Hf * Wf) + row]
    f1 = flat[z1 * (Hf * Wf) + row]
    fog = f0 * (1 - fz) + f1 * fz
    return color * fog[..., 3:4] + fog[..., :3]
