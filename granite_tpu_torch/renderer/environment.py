"""Environment lighting: procedural sky + IBL (port of
granite_tpu/renderer/environment.py).

The equirect radiance map is baked at load (numpy, identical to the
reference) into a quad+parent LOD strip (f32, C = 4) and 9 SH
irradiance coefficients.  Background pixels evaluate the analytic sky
per view ray; the prefiltered specular fetch goes through kernel B3
(ops/tile_sampler.sample_lod) at full resolution.

The offline half (tools/convert_*_to_environment): prefilter_ggx_equirect
bakes a GGX-prefiltered reflection chain in torch on the input's device,
save_baked_environment / load_baked_environment write and read it with
the SH irradiance as one GENV1 .npz, and Environment(baked=) packs the
chain (extended by box mips) into the same LOD strip B3 reads.  The
reference's tile-rect form of that strip (TiledStrips) is not ported:
B3 reads the strip.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..assets.texture_array import _resize_bilinear
from ..ops.fastmath import equirect_uv, pow07, pow07_np
from ..ops.texture import (
    build_packed_lod_strip_from_levels_np, build_packed_lod_strip_np,
)
from ..ops.tile_sampler import sample_lod
from ..utils.timeline_trace import upload


def procedural_sky_equirect(height: int = 128,
                            sun_dir=(0.35, 0.9, 0.25),
                            sun_color=(3.0, 2.8, 2.5),
                            zenith=(0.20, 0.35, 0.65),
                            horizon=(0.55, 0.62, 0.72),
                            ground=(0.22, 0.2, 0.18)) -> np.ndarray:
    """Gradient sky with a sun disk -> (H, 2H, 3) f32 linear radiance
    (u = azimuth/2pi, v = polar/pi, +Y up)."""
    w = 2 * height
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = u * 2 * np.pi
    st = np.sin(theta)[:, None]
    y = np.cos(theta)[:, None] * np.ones((1, w))
    x = st * np.cos(phi)[None, :]
    z = st * np.sin(phi)[None, :]
    sd = np.asarray(sun_dir, np.float32)
    sd = sd / np.linalg.norm(sd)
    cos_sun = x * sd[0] + y * sd[1] + z * sd[2]
    t = pow07_np(np.clip(y, 0.0, 1.0))
    sky = (np.asarray(horizon, np.float32)[None, None]
           * (1 - t[..., None])
           + np.asarray(zenith, np.float32)[None, None] * t[..., None])
    g = np.clip(-y, 0.0, 1.0)[..., None]
    img = sky * (1 - g) + np.asarray(ground, np.float32)[None, None] * g
    sun = np.clip((cos_sun - 0.9995) / 0.0005, 0.0, 1.0)[..., None]
    halo = (np.clip(cos_sun, 0, 1) ** 64)[..., None]
    img = img + np.asarray(sun_color, np.float32) * (40.0 * sun + 0.2 * halo)
    return img.astype(np.float32)


def project_sh9(env: np.ndarray) -> np.ndarray:
    """Equirect radiance -> (9, 3) irradiance-convolved SH coefficients."""
    h, w = env.shape[:2]
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = u * 2 * np.pi
    st = np.sin(theta)[:, None]
    y = np.broadcast_to(np.cos(theta)[:, None], (h, w))
    x = st * np.cos(phi)[None, :]
    z = st * np.sin(phi)[None, :]
    d_omega = (np.pi / h) * (2 * np.pi / w) * st
    Y = [0.282095 * np.ones_like(x),
         0.488603 * y, 0.488603 * z, 0.488603 * x,
         1.092548 * x * y, 1.092548 * y * z,
         0.315392 * (3 * y * y - 1.0),
         1.092548 * x * z, 0.546274 * (x * x - z * z)]
    A = [3.141593, 2.094395, 2.094395, 2.094395,
         0.785398, 0.785398, 0.785398, 0.785398, 0.785398]
    sh = np.zeros((9, 3), np.float32)
    for i in range(9):
        wgt = (Y[i] * d_omega)[..., None]
        sh[i] = (env * wgt).sum(axis=(0, 1)) * (A[i] / np.pi)
    return sh


def eval_sh9(sh, n):
    """SH irradiance at unit normals n (..., 3) -> (..., 3)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    basis = torch.stack([
        torch.full_like(x, 0.282095),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3 * y * y - 1.0),
        1.092548 * x * z, 0.546274 * (x * x - z * z)], dim=-1)
    return basis @ sh


def analytic_sky(dirs, sun_dir=(0.35, 0.9, 0.25),
                 sun_color=(3.0, 2.8, 2.5), zenith=(0.20, 0.35, 0.65),
                 horizon=(0.55, 0.62, 0.72), ground=(0.22, 0.2, 0.18)):
    """Closed-form procedural sky per view ray (..., 3) -> (..., 3)."""
    dev = dirs.device
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    n = torch.sqrt((x * x + y * y + z * z).clamp_min(1e-20))
    xn, yn, zn = x / n, y / n, z / n
    sd = np.asarray(sun_dir, np.float32)
    sd = sd / np.linalg.norm(sd)
    cos_sun = xn * float(sd[0]) + yn * float(sd[1]) + zn * float(sd[2])
    t = pow07(yn.clamp(0.0, 1.0))

    def c3(v):
        return upload(np.asarray(v, np.float32), device=dev)

    sky = c3(horizon) * (1 - t[..., None]) + c3(zenith) * t[..., None]
    g = (-yn).clamp(0.0, 1.0)[..., None]
    img = sky * (1 - g) + c3(ground) * g
    sun = ((cos_sun - 0.9995) / 0.0005).clamp(0.0, 1.0)[..., None]
    halo = (cos_sun.clamp(0, 1) ** 64)[..., None]
    return img + c3(sun_color) * (40.0 * sun + 0.2 * halo)


def env_fetch_coords(strips, dirs, covered=None):
    """Kernel B3 coordinates of an env fetch along dirs (..., 3):
    (bundle, u, v) with the equirect mapping, v kept off the poles
    (the sampler wraps both axes) and bundle -1 where not covered."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    u, v = equirect_uv(x, y, z)
    s = strips.shape[2]
    v = v.clamp(0.5 / s, 1.0 - 0.5 / s)
    bundle = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    if covered is not None:
        bundle = torch.where(covered, bundle, -1)
    return bundle, u, v


def sample_environment(strips, dirs, lod, covered=None):
    """Prefiltered env radiance along dirs (..., 3) at per-pixel lod via
    kernel B3; uncovered pixels (covered False) are skipped (0)."""
    bundle, u, v = env_fetch_coords(strips, dirs, covered)
    return sample_lod(strips, bundle, u, v, lod, 4)[..., :3]


def _equirect_dirs(h: int, w: int) -> np.ndarray:
    """(h, w, 3) f32 unit directions at the texel centers of the equirect
    mapping (u = azimuth from +X toward +Z, v = polar from +Y)."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi
    phi = u * 2 * np.pi
    st = np.sin(theta)[:, None]
    y = np.broadcast_to(np.cos(theta)[:, None], (h, w)).copy()
    x = st * np.cos(phi)[None, :]
    z = st * np.sin(phi)[None, :]
    return np.stack([x, y, z], -1).astype(np.float32)


def _sample_equirect(env: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect lookup by direction (..., 3): azimuth wraps, the
    polar axis clamps.  The weights are float64 and so is the result, as
    in the reference's numpy (int texel indices promote them)."""
    h, w = env.shape[:2]
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    n = torch.sqrt((x * x + y * y + z * z).clamp_min(1e-20))
    theta = torch.arccos((y / n).clamp(-1, 1))
    phi = torch.atan2(z, x)
    u = torch.where(phi < 0, phi + 2 * np.pi, phi) / (2 * np.pi)
    v = theta / np.pi
    fx = u * w - 0.5
    fy = (v * h - 0.5).clamp(0, h - 1)
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    ax = (fx.double() - x0)[..., None]
    ay = (fy.double() - y0)[..., None]
    x1 = (x0 + 1) % w
    x0 = x0 % w
    y1 = (y0 + 1).clamp_max(h - 1)
    t = env[y0, x0] * (1 - ax) + env[y0, x1] * ax
    b = env[y1, x0] * (1 - ax) + env[y1, x1] * ax
    return t * (1 - ay) + b * ay


def radical_inverse_vdc(bits: np.ndarray) -> np.ndarray:
    """Van der Corput radical inverse base 2 of uint32 indices, float64
    (the Hammersley sequence's second coordinate)."""
    bits = bits.astype(np.uint32)
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | \
        ((bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | \
        ((bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | \
        ((bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | \
        ((bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return bits.astype(np.float64) * 2.3283064365386963e-10


def _hammersley(samples: int) -> np.ndarray:
    """(samples, 2) float64 Hammersley points."""
    i = np.arange(samples)
    return np.stack([i / samples, radical_inverse_vdc(i)], -1)


def prefilter_ggx_equirect(env, base_size: int, levels: int,
                           samples: int = 64) -> list:
    """GGX-prefiltered specular chain (the split-sum bake of
    tools/convert_equirect_to_environment.cpp --reflection): level l is
    the environment convolved with the GGX lobe at roughness
    l / (levels - 1), importance-sampled with a Hammersley sequence
    (V = N).  env: (H, W, 3) radiance, a tensor (the bake runs on its
    device) or an array (on the CPU).  -> [(S>>l, S>>l, 3) float32
    tensors] on env's device.  Each level's tangent frame is built on the
    host as the reference builds it; each sample's half vector, its
    equirect fetch and the accumulation run on the device, in the
    reference's order."""
    env = torch.as_tensor(np.asarray(env, np.float32)) \
        if not isinstance(env, torch.Tensor) else env.float()
    dev = env.device
    xi = _hammersley(samples)
    out = []
    for l in range(levels):
        s = max(base_size >> l, 1)
        rough = l / max(levels - 1, 1)
        a = max(rough * rough, 1e-3)
        n_np = _equirect_dirs(s, s)
        up = np.where(np.abs(n_np[..., 1:2]) < 0.999,
                      np.array([0, 1, 0], np.float32),
                      np.array([1, 0, 0], np.float32))
        t_np = np.cross(up, n_np)
        t_np /= np.linalg.norm(t_np, axis=-1, keepdims=True)
        b_np = np.cross(n_np, t_np)
        N, T, B = (torch.from_numpy(np.ascontiguousarray(m)).to(dev)
                   for m in (n_np, t_np, b_np))
        acc = torch.zeros((s, s, 3), dtype=torch.float32, device=dev)
        wsum = torch.zeros((s, s, 1), dtype=torch.float32, device=dev)
        for k in range(samples):
            phi = 2 * np.pi * xi[k, 0]
            ct = np.sqrt((1 - xi[k, 1]) / (1 + (a * a - 1) * xi[k, 1]))
            st = np.sqrt(max(1 - ct * ct, 0.0))
            hl = np.array([st * np.cos(phi), st * np.sin(phi), ct],
                          np.float32)
            H = float(hl[0]) * T + float(hl[1]) * B + float(hl[2]) * N
            noh = (N * H).sum(-1, keepdim=True)
            L = 2 * noh * H - N
            nol = (N * L).sum(-1, keepdim=True).clamp_min(0)
            acc += _sample_equirect(env, L) * nol
            wsum += nol
        out.append(acc / wsum.clamp_min(1e-6))
    return out


ENV_BAKE_MAGIC = "GENV1"


def save_baked_environment(path: str, env, base_size: int = 64,
                           levels: int | None = None,
                           samples: int = 64) -> dict:
    """Offline convolver output: the GGX reflection chain (baked on env's
    device, see prefilter_ggx_equirect), the SH irradiance and a 32x64
    irradiance map evaluated from it, in one .npz at `path`.  -> the
    saved arrays (numpy)."""
    levels = levels or int(np.log2(base_size)) + 1
    refl = prefilter_ggx_equirect(env, base_size, levels, samples)
    env_np = env.cpu().numpy() if isinstance(env, torch.Tensor) \
        else np.asarray(env, np.float32)
    sh = project_sh9(env_np)
    dirs = _equirect_dirs(32, 64)
    irr = np.maximum(eval_sh9(torch.from_numpy(sh),
                              torch.from_numpy(dirs)).numpy(), 0.0)
    baked = {"magic": ENV_BAKE_MAGIC, "sh": sh,
             "irradiance": np.asarray(irr, np.float32),
             "num_levels": levels}
    baked.update({f"reflection_{l}": refl[l].cpu().numpy()
                  for l in range(levels)})
    np.savez(path, **baked)
    return baked


def load_baked_environment(path: str) -> dict:
    """A GENV1 .npz -> {"sh", "irradiance", "reflection": [levels]};
    raises ValueError for another file (the reference asserts)."""
    with np.load(path, allow_pickle=False) as z:
        if "magic" not in z or str(z["magic"]) != ENV_BAKE_MAGIC:
            raise ValueError(f"{path}: not a {ENV_BAKE_MAGIC} bake")
        n = int(z["num_levels"])
        return {"sh": z["sh"], "irradiance": z["irradiance"],
                "reflection": [z[f"reflection_{l}"] for l in range(n)]}


class Environment:
    """Sky + IBL bundle: strips (1, HS-1, S, 20) f32 LOD strip, sh (9, 3),
    num_levels, sky_params (analytic sky).  baked: load_baked_environment's
    output, whose reflection chain (extended by box mips of its roughest
    level) fills the strip and whose sh replaces the projection of
    equirect."""

    def __init__(self, equirect: np.ndarray, intensity: float = 1.0,
                 sky_params: dict | None = None, baked: dict | None = None,
                 device="cpu"):
        if baked is not None:
            levels = [np.concatenate([lv, np.ones_like(lv[..., :1])], -1)
                      for lv in baked["reflection"]]
            s = levels[0].shape[0]
            strip = build_packed_lod_strip_from_levels_np(levels,
                                                          dtype="float32")
            sh = np.asarray(baked["sh"], np.float32) * intensity
        else:
            h, w = equirect.shape[:2]
            s = 1
            while s < max(h, w):
                s *= 2
            sq = _resize_bilinear(
                np.concatenate([equirect, np.ones_like(equirect[..., :1])],
                               axis=-1), s, s)
            strip = build_packed_lod_strip_np(sq.astype(np.float32),
                                              dtype="float32")
            sh = project_sh9(equirect) * intensity
        self.strips = torch.as_tensor(strip[None], device=device)
        self.sh = torch.as_tensor(sh, device=device)
        self.num_levels = int(math.log2(s)) + 1
        self.sky_params = sky_params
