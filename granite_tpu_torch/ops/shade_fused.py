"""The whole deferred lighting expression per pixel — kernel B4 (replaces
granite_tpu/ops/shade_fused.py _shade_kernel).

Input is one stacked (P, ph, pw) plane array (P_* layout: G-buffer plus
the gather products computed outside: shadow term, specular env,
background, irradiance, top-K cluster-shadow slot/term planes), a light
table (L <= 32 rows of LC_* columns), per-64-px-tile light mask words
and 8x128 uniforms.  Per pixel: sun GGX times the shadow term, ambient
or IBL (irradiance + specular env with in-kernel fresnel), clustered
point/spot lights gated by the tile's mask word and each light's
view-depth window LC_ZLO/LC_ZHI, AO, emissive, and the background where
uncovered.  Math follows ops/pbr (Granite's PI = 3.1415628).
"""

from __future__ import annotations

import math

import torch

from ..kernels import build as K
from .pbr import cook_torrance, dot3, remap_roughness

TILE_H = 32
TILE_W = 128
CLUSTER_TILE = 64

P_BASE = 0        # 3
P_NRM = 3         # 3
P_METAL = 6
P_ROUGH = 7
P_POS = 8         # 3
P_EMISSIVE = 11   # 3
P_COVERED = 14
P_SHADOW = 15
P_SPECENV = 16    # 3
P_BACKGROUND = 19  # 3
P_AO = 22
P_IRR = 23        # 3
P_FIXED = 26      # then k slot planes, then k term planes

LC_POS = 0        # 3
LC_COLOR = 3      # 3
LC_INVR = 6
LC_DIR = 7        # 3
LC_SPOT_SCALE = 10
LC_SPOT_BIAS = 11
LC_IS_SPOT = 12
LC_ZLO = 13
LC_ZHI = 14

U_MISC = 0        # cam(0:3) sun_dir(3:6) n_lights(6) view_row2(9:13)
U_SUN_COLOR = 1   # 0:3
MAX_LIGHTS = 32   # one 32-bit mask word per tile


def fused_light_table(lights, view, z_near: float, z_far: float,
                      z_slices: int) -> torch.Tensor:
    """(L, 128) f32 light table; zlo/zhi reproduce bin_lights_z's
    z-slice quantization in view-depth space."""
    L = lights.pos.shape[0]
    dev = lights.pos.device
    log_ratio = math.log(z_far / z_near)
    vz = -(lights.pos @ view[2, :3] + view[2, 3])
    r = 1.0 / lights.inv_radius.clamp_min(1e-12)
    z0 = (vz - r).clamp_min(z_near)
    z1 = (vz + r).clamp_min(z_near)
    s0 = torch.floor(torch.log(z0 / z_near) / log_ratio * z_slices) \
        .clamp(0, z_slices - 1)
    s1 = torch.ceil(torch.log(z1 / z_near) / log_ratio * z_slices) \
        .clamp(0, z_slices)
    zlo = torch.where(s0 <= 0, torch.zeros_like(s0),
                      z_near * torch.exp(log_ratio * s0 / z_slices))
    zhi = torch.where(s1 >= z_slices, torch.full_like(s1, math.inf),
                      z_near * torch.exp(log_ratio * s1 / z_slices))
    alive = (torch.arange(L, device=dev) < lights.count) & (vz + r > z_near)
    zlo = torch.where(alive, zlo, torch.full_like(zlo, math.inf))
    zhi = torch.where(alive, zhi, torch.full_like(zhi, -math.inf))
    tbl = torch.zeros((L, 128), dtype=torch.float32, device=dev)
    tbl[:, LC_POS:LC_POS + 3] = lights.pos
    tbl[:, LC_COLOR:LC_COLOR + 3] = lights.color
    tbl[:, LC_INVR] = lights.inv_radius
    tbl[:, LC_DIR:LC_DIR + 3] = lights.dir
    tbl[:, LC_SPOT_SCALE] = lights.spot_scale_bias[:, 0]
    tbl[:, LC_SPOT_BIAS] = lights.spot_scale_bias[:, 1]
    tbl[:, LC_IS_SPOT] = lights.is_spot
    tbl[:, LC_ZLO] = zlo
    tbl[:, LC_ZHI] = zhi
    return tbl


def shade_planes_plain(planes, lights_tbl, tile_masks, uniforms, height,
                       width, *, k_shadow: int, has_env: bool,
                       has_lights: bool, has_ao: bool, ambient: bool):
    """Plain PyTorch version of kernel B4 -> (3, height, width)."""
    ph, pw = planes.shape[1:]

    def p3(i):
        return planes[i], planes[i + 1], planes[i + 2]

    cam = uniforms[U_MISC, 0:3]
    base = p3(P_BASE)
    n = p3(P_NRM)
    metal = planes[P_METAL]
    rough_raw = planes[P_ROUGH]
    rough = remap_roughness(rough_raw)
    pos = p3(P_POS)
    vx, vy, vz = (cam[0] - pos[0], cam[1] - pos[1], cam[2] - pos[2])
    vinv = torch.rsqrt(dot3(vx, vy, vz, vx, vy, vz).clamp_min(1e-20))
    v = (vx * vinv, vy * vinv, vz * vinv)
    one_m_metal = 1.0 - metal

    sun = (uniforms[U_MISC, 3], uniforms[U_MISC, 4], uniforms[U_MISC, 5])
    sun_c = (uniforms[U_SUN_COLOR, 0], uniforms[U_SUN_COLOR, 1],
             uniforms[U_SUN_COLOR, 2])
    s = list(cook_torrance(n, v, sun, sun_c, planes[P_SHADOW], base, metal,
                           rough))
    ao = planes[P_AO] if has_ao else 1.0
    if ambient:
        amb = 0.05 * one_m_metal * ao
        s = [s[c] + base[c] * amb for c in range(3)]
    if has_env:
        irr = p3(P_IRR)
        diff = one_m_metal * ao
        s = [s[c] + irr[c] * base[c] * diff for c in range(3)]
        nov_env = dot3(*n, *v).clamp(0.0, 1.0)
        t = 1.0 - nov_env
        t2 = t * t
        t5 = t2 * t2 * t
        one_m_rough = 1.0 - rough_raw
        spec = p3(P_SPECENV)
        for c in range(3):
            f0 = 0.04 + (base[c] - 0.04) * metal
            e = f0 + (torch.maximum(one_m_rough, f0) - f0) * t5
            s[c] = s[c] + spec[c] * e * ao
    if has_lights:
        acc = [torch.zeros_like(metal) for _ in range(3)]
        v2 = uniforms[U_MISC, 9:13]
        pvz = -(pos[0] * v2[0] + pos[1] * v2[1] + pos[2] * v2[2] + v2[3])
        word = tile_masks.repeat_interleave(CLUSTER_TILE, 0) \
            .repeat_interleave(CLUSTER_TILE, 1)[:ph, :pw]
        n_lights = int(uniforms[U_MISC, 6])
        for i in range(min(lights_tbl.shape[0], n_lights)):
            lt = lights_tbl[i]
            bit = (1 << i) if i < 31 else -(1 << 31)
            fx = pos[0] - lt[LC_POS]
            fy = pos[1] - lt[LC_POS + 1]
            fz = pos[2] - lt[LC_POS + 2]
            d2 = dot3(fx, fy, fz, fx, fy, fz).clamp_min(1e-12)
            dist = torch.sqrt(d2).clamp_min(0.1)          # MIN_POINT_DIST
            inv_d = 1.0 / dist
            l = (-fx * inv_d, -fy * inv_d, -fz * inv_d)
            x = dist * lt[LC_INVR]
            tt = ((x - 0.9) * 10.0).clamp(0.0, 1.0)
            static_fall = 1.0 - tt * tt * (3.0 - 2.0 * tt)
            cone = (-(l[0] * lt[LC_DIR] + l[1] * lt[LC_DIR + 1]
                      + l[2] * lt[LC_DIR + 2]) * lt[LC_SPOT_SCALE]
                    + lt[LC_SPOT_BIAS]).clamp(0.0, 1.0)
            cone = cone * cone
            fall = (cone if float(lt[LC_IS_SPOT]) > 0.5 else 1.0) \
                * static_fall
            att = fall / (dist * dist)
            col = (lt[LC_COLOR] * att, lt[LC_COLOR + 1] * att,
                   lt[LC_COLOR + 2] * att)
            sterm = torch.ones_like(metal)
            for j in range(k_shadow):
                sterm = torch.where(planes[P_FIXED + j] == float(i),
                                    planes[P_FIXED + k_shadow + j], sterm)
            r = cook_torrance(n, v, l, col, sterm, base, metal, rough)
            active = ((word & bit) != 0) & (pvz >= lt[LC_ZLO]) \
                & (pvz < lt[LC_ZHI])
            acc = [acc[c] + torch.where(active, r[c], torch.zeros_like(r[c]))
                   for c in range(3)]
        s = [s[c] + acc[c] for c in range(3)]
    em = p3(P_EMISSIVE)
    cov = planes[P_COVERED] > 0.5
    bg = p3(P_BACKGROUND)
    out = torch.stack([torch.where(cov, s[c] + em[c], bg[c])
                       for c in range(3)])
    return out[:, :height, :width]


def shade_planes_fused(planes, lights_tbl, tile_masks, uniforms,
                       height: int, width: int, *, k_shadow: int,
                       has_env: bool, has_lights: bool, has_ao: bool,
                       ambient: bool):
    """Kernel B4: planes (P, ph, pw) f32 padded to 32x128 tiles,
    lights_tbl (L<=32, 128), tile_masks (ceil(ph/64), pw/64) int32,
    uniforms (8, 128) -> (3, height, width) f32."""
    dev = planes.device
    kw = dict(k_shadow=k_shadow, has_env=has_env, has_lights=has_lights,
              has_ao=has_ao, ambient=ambient)
    if dev.type == "cpu":
        return shade_planes_plain(planes, lights_tbl, tile_masks, uniforms,
                                  height, width, **kw)
    if dev.type != "cuda":
        raise ValueError(f"shade_planes_fused: unsupported device {dev}")
    P, ph, pw = planes.shape
    K.check(planes, "planes", torch.float32, dev, 3)
    K.check(lights_tbl, "lights_tbl", torch.float32, dev, 2)
    K.check(tile_masks, "tile_masks", torch.int32, dev, 2)
    K.check(uniforms, "uniforms", torch.float32, dev, 2)
    if ph % TILE_H or pw % TILE_W or P != P_FIXED + 2 * k_shadow:
        raise ValueError(f"shade_planes_fused: planes {tuple(planes.shape)}"
                         f" for k_shadow={k_shadow}")
    if lights_tbl.shape[0] > MAX_LIGHTS or lights_tbl.shape[1] != 128:
        raise ValueError("shade_planes_fused: light table must be "
                         "(L <= 32, 128)")
    if tile_masks.shape != (-(-ph // CLUSTER_TILE), pw // CLUSTER_TILE):
        raise ValueError(f"shade_planes_fused: tile masks "
                         f"{tuple(tile_masks.shape)} for ({ph}, {pw})")
    if uniforms.shape != (8, 128):
        raise ValueError("shade_planes_fused: uniforms must be (8, 128)")
    out = torch.empty((3, ph, pw), dtype=torch.float32, device=dev)
    K.launch("B4", "granite_shade_fused", K.ptr(planes), P, ph, pw,
             K.ptr(lights_tbl), lights_tbl.shape[0], K.ptr(tile_masks),
             tile_masks.shape[1], K.ptr(uniforms), k_shadow, int(has_env),
             int(has_lights), int(has_ao), int(ambient), K.ptr(out))
    return out[:, :height, :width]
