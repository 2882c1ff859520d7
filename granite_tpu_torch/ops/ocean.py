"""FFT ocean simulation (port of granite_tpu/ops/ocean.py; reference:
renderer/ocean.cpp + assets/shaders/ocean/generate_fft.comp).

  * Phillips-style spectrum (ocean.cpp:1420) and the Gaussian initial
    distribution h0(k): numpy, seeded with RandomState exactly as the
    reference, so both packages start from the same bytes.
  * Time evolution: dispersion w = sqrt(g|k|) rounded to the animation
    period; H(k,t) = h0(k) e^{iwt} + conj(h0(-k)) e^{-iwt}.
  * ocean_maps: height, horizontal displacement (i*k/|k|*H) and gradient
    (i*k*H) through three 2D inverse FFTs (torch.fft; jnp.fft in the
    reference, never a Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from .texture import WRAP_REPEAT, sample_level

G = 9.81


def alias_freq(n: int) -> np.ndarray:
    """Signed frequency index per bin (ocean.cpp alias())."""
    x = np.arange(n)
    return np.where(x > n // 2, x - n, x).astype(np.float32)


def phillips(kx, ky, max_l: float, wind_dir, L: float):
    k_len = np.sqrt(kx * kx + ky * ky)
    # Clamp to the smallest nonzero |k| present so safe**-4 stays finite
    # in float32; the DC bin is zeroed by the where anyway.
    nonzero = k_len[k_len > 0.0]
    floor = float(nonzero.min()) if nonzero.size else 1.0
    safe = np.maximum(k_len, floor)
    kw = (kx * wind_dir[0] + ky * wind_dir[1]) / safe
    kL = safe * L
    p = (kw * kw
         * np.exp(-(safe * max_l) ** 2)
         * np.exp(-1.0 / np.maximum(kL * kL, 1e-12))
         * safe ** -4.0)
    return np.where(k_len == 0.0, 0.0, p)


def generate_distribution(n: int, world_size, amplitude: float,
                          wind_velocity, max_l: float = 0.02,
                          seed: int = 0) -> np.ndarray:
    """h0(k): (N, N) complex64 initial spectrum (ocean.cpp:1460-1480)."""
    rng = np.random.RandomState(seed)
    wind_velocity = np.asarray(wind_velocity, np.float32)
    L = float(wind_velocity @ wind_velocity) / G
    wind_dir = wind_velocity / max(np.linalg.norm(wind_velocity), 1e-9)
    mod = 2.0 * np.pi / np.asarray(world_size, np.float32)
    # amplitude normalized by frequency-space density (ocean.cpp:58)
    amp = amplitude * np.sqrt(mod[0] * mod[1])
    fx = alias_freq(n) * mod[0]
    fy = alias_freq(n) * mod[1]
    kx, ky = np.meshgrid(fx, fy)
    p = phillips(kx, ky, max_l, wind_dir, L)
    dist = rng.normal(0, 1, (n, n, 2)).astype(np.float32)
    h0 = (dist[..., 0] + 1j * dist[..., 1]) * (amp * np.sqrt(0.5 * p))
    return h0.astype(np.complex64)


def _freq_grids(n: int, world_size, device="cpu"):
    """(kx, ky, |k|) as (N, N) float32 tensors on `device`."""
    mod = 2.0 * np.pi / np.asarray(world_size, np.float32)
    fx = alias_freq(n) * mod[0]
    fy = alias_freq(n) * mod[1]
    kx, ky = np.meshgrid(fx, fy)
    k_len = np.sqrt(kx * kx + ky * ky)
    return tuple(torch.as_tensor(a, device=device) for a in (kx, ky, k_len))


def evolve_spectrum(h0, kx, ky, k_len, t, period: float = 256.0):
    """H(k,t) with period-rounded dispersion (generate_fft.comp:80-90).
    t: float or 0-d float32 tensor."""
    w = torch.sqrt(G * k_len)
    w = torch.round(w * period) / period
    phase = w * t
    e = torch.complex(torch.cos(phase), torch.sin(phase))
    # conj(h0(-k)): reverse indices modulo N in both axes.
    h0r = torch.roll(torch.flip(h0, dims=(0, 1)), shifts=(1, 1),
                     dims=(0, 1))
    return h0 * e + torch.conj(h0r) * torch.conj(e)


def ocean_maps(h0, kx, ky, k_len, t, period: float = 256.0):
    """One simulation step -> (height (N,N), disp_xy (N,N,2),
    grad_xy (N,N,2)) real fields via three 2D IFFTs (ocean.cpp:697)."""
    H = evolve_spectrum(h0, kx, ky, k_len, t, period)
    n2 = H.shape[0] * H.shape[1]
    height = torch.real(torch.fft.ifft2(H)) * n2

    ik = torch.complex(-ky, kx)              # 1j * (kx + 1j * ky)
    grad = torch.fft.ifft2(ik * H) * n2
    grad_xy = torch.stack([torch.real(grad), torch.imag(grad)], dim=-1)

    k_safe = k_len.clamp_min(1e-5)
    disp = torch.fft.ifft2(ik / k_safe * H) * n2
    disp_xy = torch.stack([torch.real(disp), torch.imag(disp)], dim=-1)
    return height, disp_xy, grad_xy


def sample_heightfield(height, disp_xy, grad_xy, u, v, lambda_disp: float):
    """Bilinear-sample the periodic ocean maps at normalized (u, v) ->
    (height, dx, dz, gradient) for vertex displacement."""
    stack = torch.cat([height[..., None], disp_xy, grad_xy],
                      dim=-1)[None]                      # (1, N, N, 5)
    s = sample_level(stack, u, v, 0, wrap=WRAP_REPEAT)
    h = s[..., 0]
    dx = -lambda_disp * s[..., 1]
    dz = -lambda_disp * s[..., 2]
    grad = s[..., 3:5]
    return h, dx, dz, grad
