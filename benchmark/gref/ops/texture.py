# Frozen copy of granite_tpu_torch/ops/texture.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""Texture strips and sampling math (port of granite_tpu/ops/texture.py).

The numpy strip builders are copies of the reference's load-time
builders (the reference module imports jax, so they cannot be imported
from it); tests/test_torch_sampler.py holds each copy equal to its
original.  The mip-stack samplers (build_mips, sample_level,
sample_trilinear: the ocean and terrain displacement maps) and the
quad-packed strip sampler (sample_packed_level: the decals, clamp
addressed) are torch versions of the reference's, held against it in
tests/test_torch_ocean.py and tests/test_torch_decals.py.

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


def build_gutter_strip_np(img, wrap: int = WRAP_REPEAT, dtype="float32"):
    """(S, S, C) float -> (HS, S+1, C) gutter strip (numpy, load-time)."""
    s, s2, C = img.shape
    assert s == s2 and (s & (s - 1)) == 0, "square pow2 required"
    L = num_mip_levels(s, s)
    HS, WS = gutter_strip_height(s), s + 1
    out = np.zeros((HS, WS, C), np.float32)
    cur = np.asarray(img, np.float32)
    off = 0
    for l in range(L):
        ls = max(s >> l, 1)
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
        if ls > 1:
            cur = cur[:ls // 2 * 2, :ls // 2 * 2] \
                .reshape(ls // 2, 2, ls // 2, 2, C).mean(axis=(1, 3))
    return out.astype(dtype)


def build_packed_strip_np(img, wrap: int = WRAP_REPEAT, dtype="float16"):
    """(S, S, C) float -> (HS-1, S, 4C) quad-packed gutter strip: one row
    fetch at (y, x) yields the 2x2 footprint [t00 | t10 | t01 | t11],
    correct at every level border for the given wrap mode."""
    strip = build_gutter_strip_np(img, wrap, dtype="float32")
    packed = np.concatenate(
        [strip[:-1, :-1], strip[:-1, 1:], strip[1:, :-1], strip[1:, 1:]],
        axis=-1)
    return packed.astype(dtype)


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
    return _pack_lod_levels_np(_box_mip_levels_np(img), wrap, dtype)


def build_packed_lod_strip_from_levels_np(levels, wrap: int = WRAP_REPEAT,
                                          dtype="float32"):
    """Explicit per-level images (e.g. a GGX-prefiltered chain) -> the
    (HS-1, S, 5C) LOD strip of build_packed_lod_strip_np; levels past
    the given list are box-filtered continuations of its last."""
    s = levels[0].shape[0]
    C = levels[0].shape[-1]
    L = num_mip_levels(s, s)
    full = [np.asarray(lv, np.float32) for lv in levels]
    cur = full[-1]
    while len(full) < L:
        n2 = max(cur.shape[0] // 2, 1)
        if cur.shape[0] > 1:
            cur = cur[:n2 * 2, :n2 * 2].reshape(
                n2, 2, n2, 2, C).mean(axis=(1, 3))
        full.append(cur)
    return _pack_lod_levels_np(full, wrap, dtype)


def _pack_lod_levels_np(levels, wrap: int, dtype):
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


def _gutter_level_coords(S: int, u, v, level, wrap: int = WRAP_REPEAT):
    """Start texel (row, col) + bilinear fracs for one gutter-strip level.
    Repeat wraps the start texel; clamp keeps the 2x2 footprint inside
    the level and clamps the fracs to [0, 1]."""
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
    if wrap == WRAP_REPEAT:
        x0 = torch.remainder(saturating_int32(x0f), ls)
        y0 = torch.remainder(saturating_int32(y0f), ls)
        return row0 + y0, x0, x - x0f, y - y0f
    hi = torch.clamp_min(ls - 2, 0)
    x0 = torch.minimum(saturating_int32(x0f).clamp_min(0), hi)
    y0 = torch.minimum(saturating_int32(y0f).clamp_min(0), hi)
    fx = (x - x0.to(x.dtype)).clamp(0.0, 1.0)
    fy = (y - y0.to(y.dtype)).clamp(0.0, 1.0)
    return row0 + y0, x0, fx, fy


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


def sample_packed_level(packed: torch.Tensor, tex_id, u, v, level,
                        channels: int, wrap: int = WRAP_REPEAT):
    """Bilinear from a (N, HS-1, S, 4C) quad-packed strip at integer
    `level`: one row fetch a pixel.  tex_id, u, v (and level, an int
    tensor or int) broadcast together; returns (..., C) float32."""
    S = packed.shape[2]
    level = torch.as_tensor(level, dtype=torch.int32, device=u.device)
    level = torch.broadcast_to(level, u.shape)
    yy, xx, fx, fy = _gutter_level_coords(S, u, v, level, wrap)
    tex_id = torch.broadcast_to(torch.as_tensor(tex_id, device=u.device),
                                u.shape)
    quad = packed[tex_id.long(), yy.long(), xx.long()].float()
    quad = quad[..., :4 * channels].reshape(quad.shape[:-1]
                                            + (4, channels))
    fx = fx[..., None]
    fy = fy[..., None]
    top = quad[..., 0, :] * (1 - fx) + quad[..., 1, :] * fx
    bot = quad[..., 2, :] * (1 - fx) + quad[..., 3, :] * fx
    return top * (1 - fy) + bot * fy


# ---------------------------------------------------------------------------
# Mip stacks: (L, H, W, C) with level l in the top-left (H>>l, W>>l) region
# (the rest zero).  The ocean's and the LOD terrain's displacement maps.
# ---------------------------------------------------------------------------

def build_mips(img: torch.Tensor, levels: int | None = None) -> torch.Tensor:
    """Box-filter mip chain (2x2 average) -> (L, H, W, C) stack."""
    h, w = img.shape[0], img.shape[1]
    L = levels or num_mip_levels(h, w)
    out = torch.zeros((L, h, w, img.shape[-1]), dtype=img.dtype,
                      device=img.device)
    out[0] = img
    cur = img
    for l in range(1, L):
        ch, cw = cur.shape[0], cur.shape[1]
        nh, nw = max(ch // 2, 1), max(cw // 2, 1)
        if ch > 1 and cw > 1:
            cur = cur[:nh * 2, :nw * 2].reshape(nh, 2, nw, 2, -1) \
                .mean(dim=(1, 3))
        elif ch > 1:
            cur = cur[:nh * 2].reshape(nh, 2, cw, -1).mean(dim=1)
        elif cw > 1:
            cur = cur[:, :nw * 2].reshape(ch, nw, 2, -1).mean(dim=2)
        out[l, :cur.shape[0], :cur.shape[1]] = cur
    return out


def _wrap_coord(c, size, wrap: int):
    if wrap == WRAP_REPEAT:
        return torch.remainder(c, size)
    return torch.minimum(c.clamp_min(0), size - 1)


def sample_level(mips: torch.Tensor, u, v, level, wrap: int = WRAP_REPEAT):
    """Bilinear sample of one mip level (texel centers at (i + 0.5) / S).
    mips: (L, H, W, C); level: int tensor broadcastable to u, or an int."""
    L, H, W, _C = mips.shape
    level = torch.broadcast_to(
        torch.as_tensor(level, dtype=torch.int32, device=u.device),
        u.shape).clamp(0, L - 1)
    lh = torch.clamp_min(torch.bitwise_right_shift(
        torch.full_like(level, H), level), 1)
    lw = torch.clamp_min(torch.bitwise_right_shift(
        torch.full_like(level, W), level), 1)
    x = u * lw.to(u.dtype) - 0.5
    y = v * lh.to(v.dtype) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = saturating_int32(x0)
    y0i = saturating_int32(y0)
    x0w = _wrap_coord(x0i, lw, wrap).long()
    x1w = _wrap_coord(x0i + 1, lw, wrap).long()
    y0w = _wrap_coord(y0i, lh, wrap).long()
    y1w = _wrap_coord(y0i + 1, lh, wrap).long()
    lv = level.long()
    t00 = mips[lv, y0w, x0w]
    t10 = mips[lv, y0w, x1w]
    t01 = mips[lv, y1w, x0w]
    t11 = mips[lv, y1w, x1w]
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def sample_trilinear(mips: torch.Tensor, u, v, lod,
                     wrap: int = WRAP_REPEAT):
    """Bilinear at floor(lod) and floor(lod) + 1, lerped."""
    L = mips.shape[0]
    lod = lod.clamp(0.0, L - 1.0)
    l0 = saturating_int32(torch.floor(lod))
    frac = (lod - l0.to(lod.dtype))[..., None]
    a = sample_level(mips, u, v, l0, wrap)
    b = sample_level(mips, u, v, torch.clamp_max(l0 + 1, L - 1), wrap)
    return a * (1 - frac) + b * frac
