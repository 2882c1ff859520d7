"""Texture-pipeline utilities (copy of
granite_tpu/scene_export/texture_utils.py; reference
scene-export/texture_utils.cpp).

One reference fault is fixed in this copy: swizzle_image's ONE for a
float16 image was np.uint16(0x3C00), the bit pattern of 1.0, which a
float16 array takes by value as 15360.0; here ONE is 1 in the image's
own type, np.float16(1.0) for float16.

Vectorized numpy re-implementations of the reference's offline texture
helpers:
  * generate_mipmaps        (:133-210) — bilinear mip chain, sRGB-aware
  * fixup_alpha_edges       (:242-342) — bleed neighbour RGB into
                                          transparent texels
  * swizzle_image           (:344-473) — component remap incl. ONE/ZERO
  * image_slice_contains_transparency (:475-511) — None/Binary/Floating

All functions take (H, W, 4) uint8 arrays (the RGBA8 formats the
reference supports for these ops) and run whole-image vectorized —
there is no GPU involvement in the reference either (CPU asset
pipeline), so numpy is the idiomatic port.
"""

from __future__ import annotations

from enum import Enum

import numpy as np


class TransparencyType(Enum):
    NONE = 0       # every texel alpha == 255
    BINARY = 1     # alphas are only 0 or 255 (alpha-test material)
    FLOATING = 2   # intermediate alphas exist (alpha-blend material)


def srgb_gamma_to_linear(v: np.ndarray) -> np.ndarray:
    """texture_utils.cpp:82-88 (float in [0,1])."""
    v = np.asarray(v, np.float32)
    return np.where(v <= 0.04045, v / 12.92,
                    ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)


def srgb_linear_to_gamma(v: np.ndarray) -> np.ndarray:
    """texture_utils.cpp:90-96."""
    v = np.asarray(v, np.float32)
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.maximum(v, 0.0) ** (1 / 2.4) - 0.055) \
        .astype(np.float32)


def _to_float(img: np.ndarray, srgb: bool) -> np.ndarray:
    f = img.astype(np.float32) / 255.0
    if srgb:
        f = np.concatenate([srgb_gamma_to_linear(f[..., :3]),
                            f[..., 3:]], axis=-1)
    return f


def _to_u8(f: np.ndarray, srgb: bool) -> np.ndarray:
    if srgb:
        f = np.concatenate([srgb_linear_to_gamma(f[..., :3]),
                            f[..., 3:]], axis=-1)
    return np.clip(np.round(f * 255.0), 0, 255).astype(np.uint8)


def _bilinear_downsample(src: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """One mip step at arbitrary scale (texture_utils.cpp:138-199):
    sample the source bilinearly at the destination texel centers
    rescaled into source space (handles non-power-of-two chains the
    same way the reference does)."""
    sh, sw = src.shape[:2]
    cy = (np.arange(dh, dtype=np.float32) + 0.5) * (sh / dh) - 0.5
    cx = (np.arange(dw, dtype=np.float32) + 0.5) * (sw / dw) - 0.5
    fy = np.floor(cy)
    fx = np.floor(cx)
    uy = (cy - fy)[:, None, None]
    ux = (cx - fx)[None, :, None]
    y0 = np.clip(fy.astype(np.int64), 0, sh - 1)
    x0 = np.clip(fx.astype(np.int64), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    c00 = src[y0[:, None], x0[None, :]]
    c10 = src[y0[:, None], x1[None, :]]
    c01 = src[y1[:, None], x0[None, :]]
    c11 = src[y1[:, None], x1[None, :]]
    top = c00 * (1 - ux) + c10 * ux
    bot = c01 * (1 - ux) + c11 * ux
    return (top * (1 - uy) + bot * uy).astype(np.float32)


def generate_mipmaps(img: np.ndarray, srgb: bool = False) -> list:
    """Full mip chain [level0, level1, ...] down to 1x1
    (texture_utils.cpp generate_mipmaps :133-210; sRGB images filter in
    linear space like the TextureFormatRGBA8Srgb ops)."""
    assert img.ndim == 3 and img.shape[2] == 4 and img.dtype == np.uint8
    chain = [img]
    f = _to_float(img, srgb)
    h, w = img.shape[:2]
    while h > 1 or w > 1:
        h = max(h // 2, 1)
        w = max(w // 2, 1)
        f = _bilinear_downsample(f, w, h)
        chain.append(_to_u8(f, srgb))
    return chain


def fixup_alpha_edges(img: np.ndarray, srgb: bool = False) -> np.ndarray:
    """Bleed alpha-weighted neighbour RGB into non-opaque texels
    (texture_utils.cpp fixup_edges :242-289): for every texel with
    alpha < 1, replace RGB with mix(weighted-neighbour-RGB, RGB, alpha)
    so bilinear filtering across alpha edges doesn't pull in black."""
    assert img.ndim == 3 and img.shape[2] == 4 and img.dtype == np.uint8
    f = _to_float(img, srgb)
    rgb = f[..., :3]
    a = f[..., 3:]
    wrgb = np.zeros_like(rgb)
    wsum = np.zeros_like(a)
    pad_rgb = np.pad(rgb * a, ((1, 1), (1, 1), (0, 0)), mode="edge")
    pad_a = np.pad(a, ((1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = img.shape[:2]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            wrgb += pad_rgb[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            wsum += pad_a[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    nbr = wrgb / np.maximum(wsum, 1e-7)
    fixed = nbr * (1 - a) + rgb * a
    out = np.where(a == 1.0, rgb, fixed)
    return _to_u8(np.concatenate([out, a], axis=-1), srgb)


# VkComponentSwizzle analogue: "r","g","b","a","one","zero","identity"
_SWIZ = {"r": 0, "g": 1, "b": 2, "a": 3, "one": 4, "zero": 5}


def swizzle_image(img: np.ndarray, swizzle) -> np.ndarray:
    """Component remap (texture_utils.cpp swizzle_image :430-473).

    swizzle: 4 entries from {"r","g","b","a","one","zero","identity"}
    (identity keeps the positional component, like
    VK_COMPONENT_SWIZZLE_IDENTITY)."""
    assert img.ndim == 3 and img.shape[2] == 4
    out = np.empty_like(img)
    one = np.array(255 if img.dtype == np.uint8 else 1, img.dtype)
    for i, s in enumerate(swizzle):
        s = str(s).lower()
        if s == "identity":
            s = "rgba"[i]
        code = _SWIZ[s]
        if code == 4:
            out[..., i] = one
        elif code == 5:
            out[..., i] = 0
        else:
            out[..., i] = img[..., code]
    return out


def image_slice_contains_transparency(img: np.ndarray) -> TransparencyType:
    """texture_utils.cpp check_transparency :475-496."""
    a = img[..., 3]
    if (a == 255).all():
        return TransparencyType.NONE
    if np.isin(a, (0, 255)).all():
        return TransparencyType.BINARY
    return TransparencyType.FLOATING
