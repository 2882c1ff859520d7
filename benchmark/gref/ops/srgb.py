# Frozen copy of granite_tpu_torch/ops/srgb.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""sRGB transfer functions (port of granite_tpu/ops/srgb.py): the exact
IEC 61966-2-1 piecewise curve."""

from __future__ import annotations

import numpy as np
import torch


def linear_to_srgb(x):
    x = x.clamp(0.0, 1.0)
    lo = x * 12.92
    hi = 1.055 * torch.pow(x.clamp_min(1e-7), 1.0 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, lo, hi)


def srgb_to_linear(x):
    x = x.clamp(0.0, 1.0)
    lo = x / 12.92
    hi = torch.pow((x + 0.055) / 1.055, 2.4)
    return torch.where(x <= 0.04045, lo, hi)


def srgb_u8_to_linear_np(arr: np.ndarray) -> np.ndarray:
    """uint8 sRGB (H, W, 4) -> float32 linear, alpha kept linear (host
    LUT, texture upload path)."""
    u = np.arange(256, dtype=np.float32) / 255.0
    lut = np.where(u <= 0.04045, u / 12.92,
                   ((u + 0.055) / 1.055) ** 2.4).astype(np.float32)
    out = lut[arr]
    out[..., 3] = arr[..., 3].astype(np.float32) / 255.0
    return out


def encode_rgba8(linear_rgb, alpha=None):
    """Linear float RGB (H, W, 3) -> sRGB uint8 RGBA (H, W, 4) (the
    swapchain-blit analogue); alpha (H, W) or (H, W, 1) in [0, 1],
    clamped, or None for 255."""
    u8 = torch.round(linear_to_srgb(linear_rgb) * 255.0).to(torch.uint8)
    if alpha is None:
        a = torch.full(u8.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=u8.device)
    else:
        a = torch.round(alpha.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        a = a[..., None] if a.dim() == u8.dim() - 1 else a
    return torch.cat([u8, a], dim=-1)
