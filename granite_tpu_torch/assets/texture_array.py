"""Texture registry used by pack_scene (numpy copy of the helpers of
granite_tpu/assets/texture_array.py, whose module imports jax through
granite_tpu/ops).  Index 0 is a white texture, index 1 a flat normal map
— material slots without a texture point there."""

from __future__ import annotations

import numpy as np

from ..ops.srgb import srgb_u8_to_linear_np

WHITE_TEXTURE = 0
FLAT_NORMAL_TEXTURE = 1
NUM_BUILTIN_TEXTURES = 2


class TextureArrayBuilder:
    """Linear float32 RGBA images resampled to one base size."""

    def __init__(self, base_size: int = 512):
        self.base_size = base_size
        white = np.ones((base_size, base_size, 4), np.float32)
        normal = np.zeros((base_size, base_size, 4), np.float32)
        normal[..., 0:2] = 0.5
        normal[..., 2] = 1.0
        normal[..., 3] = 1.0
        self._images: list[np.ndarray] = [white, normal]

    def add_image(self, img_u8: np.ndarray, srgb: bool) -> int:
        """Add an (H, W, 4) uint8 image; returns its texture index."""
        if srgb:
            linear = srgb_u8_to_linear_np(img_u8)
        else:
            linear = img_u8.astype(np.float32) / 255.0
        s = self.base_size
        if linear.shape[0] != s or linear.shape[1] != s:
            linear = _resize_bilinear(linear, s, s)
        self._images.append(linear.astype(np.float32))
        return len(self._images) - 1


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    y = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    x = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(y - y0, 0, 1)[:, None, None]
    fx = np.clip(x - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    b = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return (a * (1 - fy) + b * fy).astype(np.float32)
