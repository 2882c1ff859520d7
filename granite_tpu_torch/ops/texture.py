"""Texture strips and sampling math (port of granite_tpu/ops/texture.py).

The numpy strip builders are copies of the reference's load-time
builders (the reference module imports jax, so they cannot be imported
from it); tests/test_torch_sampler.py holds each copy equal to its
original.

Gutter-strip layout: level l of a base-size-S strip holds ls = S>>l
texels at rows [off, off+ls) with off = 2S - (2S>>l) + l, plus one
gutter row/column baking the wrap mode in, so a bilinear footprint is
always a contiguous 2x2 patch.  The LOD strip packs per texel
[t00 t10 t01 t11 | parent] (5C channels): ONE row fetch yields the
bilinear quad and the next level pre-filtered at the texel center.
"""

from __future__ import annotations

import numpy as np
import torch

WRAP_REPEAT = 0
WRAP_CLAMP = 1


def num_mip_levels(h: int, w: int) -> int:
    n = 1
    while h > 1 or w > 1:
        h, w = max(h // 2, 1), max(w // 2, 1)
        n += 1
    return n


def gutter_strip_height(size: int) -> int:
    return 2 * size + num_mip_levels(size, size) - 1


def quad_pack2d(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, 4C) channels [t00 | t10 | t01 | t11], edge
    clamped: one fetch at (y0, x0) returns the bilinear footprint."""
    p = torch.cat([img, img[-1:]], dim=0)
    p = torch.cat([p, p[:, -1:]], dim=1)
    return torch.cat([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]],
                     dim=-1)


def _box_mip_levels_np(img):
    s = img.shape[0]
    L = num_mip_levels(s, s)
    cur = np.asarray(img, np.float32)
    levels = [cur]
    for _ in range(1, L):
        ls = cur.shape[0]
        if ls > 1:
            n2 = ls // 2
            cur = cur[:n2 * 2, :n2 * 2].reshape(
                n2, 2, n2, 2, -1).mean(axis=(1, 3))
        levels.append(cur)
    return levels


def _gutter_from_levels_np(levels, wrap: int):
    s = levels[0].shape[0]
    C = levels[0].shape[-1]
    L = num_mip_levels(s, s)
    HS, WS = gutter_strip_height(s), s + 1
    out = np.zeros((HS, WS, C), np.float32)
    off = 0
    for l in range(L):
        ls = max(s >> l, 1)
        cur = np.asarray(levels[l], np.float32)
        ext = np.zeros((ls + 1, ls + 1, C), np.float32)
        ext[:ls, :ls] = cur
        if wrap == WRAP_REPEAT:
            ext[:ls, ls] = cur[:, 0]
            ext[ls, :ls] = cur[0, :]
            ext[ls, ls] = cur[0, 0]
        else:
            ext[:ls, ls] = cur[:, -1]
            ext[ls, :ls] = cur[-1, :]
            ext[ls, ls] = cur[-1, -1]
        out[off:off + ls + 1, :ls + 1] = ext
        off += ls + 1
    return out


def _upsample2_centers_np(img, wrap: int):
    """Bilinear 2x upsample at the FINE texel centers (the baked parent
    tap of the LOD strip)."""
    n = img.shape[0]
    out_n = n * 2
    pos = (np.arange(out_n) + 0.5) / 2.0 - 0.5
    i0 = np.floor(pos).astype(int)
    f = pos - i0
    if wrap == WRAP_REPEAT:
        a0 = i0 % n
        a1 = (i0 + 1) % n
    else:
        a0 = np.clip(i0, 0, n - 1)
        a1 = np.clip(i0 + 1, 0, n - 1)
    fy = f[:, None, None]
    rows = img[a0] * (1 - fy) + img[a1] * fy
    fx = f[None, :, None]
    return rows[:, a0] * (1 - fx) + rows[:, a1] * fx


def build_packed_lod_strip_np(img, wrap: int = WRAP_REPEAT,
                              dtype="float16"):
    """(S, S, C) -> (HS-1, S, 5C) LOD strip [t00 t10 t01 t11 | parent]."""
    levels = _box_mip_levels_np(img)
    parents = [(_upsample2_centers_np(levels[l + 1], wrap)
                if l + 1 < len(levels) else levels[l])
               for l in range(len(levels))]
    gf = _gutter_from_levels_np(levels, wrap)
    gp = _gutter_from_levels_np(parents, wrap)
    packed = np.concatenate(
        [gf[:-1, :-1], gf[:-1, 1:], gf[1:, :-1], gf[1:, 1:],
         gp[:-1, :-1]], axis=-1)
    return packed.astype(dtype)


def lod_from_derivs(dudx, dvdx, dudy, dvdy, width: int, height: int,
                    bias: float = 0.0):
    """Mip LOD from UV screen derivatives (the HW ddx/ddy rule)."""
    sx = torch.sqrt((dudx * width) ** 2 + (dvdx * height) ** 2)
    sy = torch.sqrt((dudy * width) ** 2 + (dvdy * height) ** 2)
    rho = torch.maximum(sx, sy).clamp_min(1e-12)
    return torch.log2(rho) + bias


INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def saturating_int32(x):
    """Float -> int32 as XLA converts (and PTX's cvt): values >= 2^31
    (and +inf) give INT32_MAX, values < -2^31 (and -inf) INT32_MIN, NaN
    gives 0.  A plain torch cast on the CPU maps all of them to INT32_MIN.
    Not a clamp into a texture's range: `remainder` needs the saturated
    integer itself."""
    big = x >= 2.0 ** 31
    small = x < -2.0 ** 31
    inside = ~(big | small | torch.isnan(x))
    xi = torch.where(inside, x, torch.zeros_like(x)).to(torch.int32)
    xi = torch.where(big, INT32_MAX, xi)
    return torch.where(small, INT32_MIN, xi)


def _gutter_level_coords(S: int, u, v, level):
    """Start texel (row, col) + bilinear fracs for one gutter-strip level
    (repeat addressing: the port's strips are all baked with repeat)."""
    L = num_mip_levels(S, S)
    level = level.clamp(0, L - 1)
    ls = torch.clamp_min(torch.bitwise_right_shift(
        torch.full_like(level, S), level), 1)
    row0 = 2 * S - torch.bitwise_right_shift(
        torch.full_like(level, 2 * S), level) + level
    lsf = ls.to(u.dtype)
    x = u * lsf - 0.5
    y = v * lsf - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    x0 = torch.remainder(saturating_int32(x0f), ls)
    y0 = torch.remainder(saturating_int32(y0f), ls)
    return row0 + y0, x0, x - x0f, y - y0f


def sample_packed_lod(packed: torch.Tensor, tex_id, u, v, lod,
                      channels: int):
    """Approximate trilinear from a (N, HS-1, S, 5C) LOD strip: bilinear
    quad at floor(lod) lerped to the pre-filtered parent tap.  tex_id,
    u, v, lod share one shape (...); returns (..., C) float32."""
    S = packed.shape[2]
    L = num_mip_levels(S, S)
    lod = lod.clamp(0.0, L - 1.0)
    l0 = saturating_int32(torch.floor(lod))
    frac = (lod - l0.to(lod.dtype))[..., None]
    yy, xx, fx, fy = _gutter_level_coords(S, u, v, l0)
    row = packed[tex_id.long(), yy.long(), xx.long()].float()
    quad = row[..., :4 * channels].reshape(row.shape[:-1] + (4, channels))
    fx = fx[..., None]
    fy = fy[..., None]
    top = quad[..., 0, :] * (1 - fx) + quad[..., 1, :] * fx
    bot = quad[..., 2, :] * (1 - fx) + quad[..., 3, :] * fx
    fine = top * (1 - fy) + bot * fy
    parent = row[..., 4 * channels:]
    return fine * (1 - frac) + parent * frac
