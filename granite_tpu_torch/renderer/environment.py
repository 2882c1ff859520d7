"""Environment lighting: procedural sky + IBL (port of
granite_tpu/renderer/environment.py, procedural path).

The equirect radiance map is baked at load (numpy, identical to the
reference) into a quad+parent LOD strip (f32, C = 4) and 9 SH
irradiance coefficients.  Background pixels evaluate the analytic sky
per view ray; the prefiltered specular fetch goes through kernel B3
(ops/tile_sampler.sample_lod) at full resolution.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..assets.texture_array import _resize_bilinear
from ..ops.fastmath import equirect_uv, pow07, pow07_np
from ..ops.texture import build_packed_lod_strip_np
from ..ops.tile_sampler import sample_lod


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
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

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


class Environment:
    """Sky + IBL bundle: strips (1, HS-1, S, 20) f32 LOD strip, sh (9, 3),
    num_levels, sky_params (analytic sky)."""

    def __init__(self, equirect: np.ndarray, intensity: float = 1.0,
                 sky_params: dict | None = None, device="cpu"):
        h, w = equirect.shape[:2]
        s = 1
        while s < max(h, w):
            s *= 2
        sq = _resize_bilinear(
            np.concatenate([equirect, np.ones_like(equirect[..., :1])],
                           axis=-1), s, s)
        strip = build_packed_lod_strip_np(sq.astype(np.float32),
                                          dtype="float32")
        self.strips = torch.as_tensor(strip[None], device=device)
        self.sh = torch.as_tensor(project_sh9(equirect) * intensity,
                                  device=device)
        self.num_levels = int(math.log2(s)) + 1
        self.sky_params = sky_params
