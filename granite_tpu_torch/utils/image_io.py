"""Image save and load (copy of granite_tpu/utils/image_io.py; reference:
renderer/utils/image_utils.cpp:312 and the headless platform's PNG
dump).  The sRGB decode is the port's own ops/srgb.py."""

from __future__ import annotations

import numpy as np

from ..ops.srgb import srgb_u8_to_linear_np


def save_png(path: str, rgba: np.ndarray) -> None:
    """Save (H, W, 3|4) uint8 or float [0,1] image as PNG."""
    from PIL import Image
    arr = np.asarray(rgba)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_image(path: str, srgb_to_linear: bool = False) -> np.ndarray:
    """Load an image file to (H, W, 4) uint8 (or float32 if converting)."""
    from PIL import Image
    img = Image.open(path)
    if img.mode != "RGBA":
        img = img.convert("RGBA")
    arr = np.asarray(img, dtype=np.uint8)
    if srgb_to_linear:
        return srgb_u8_to_linear_np(arr)
    return arr
