"""Fused raster + visibility resolve (port of granite_tpu/ops/raster_fused.py)
with kernel B2.

Packets carry the resolve payload in lanes 21-84 (offset-folded
adjugate, 3 corners x (pos, nrm, tan4, uv), base color and
metallic/roughness factors, bundle id, emissive, 3 corners x previous
world pos).  B2 runs B1's walk (the slices of raster_binned.walk_items,
merged per pixel into the winning packet's key); a resolve phase then
loads each pixel's winning payload straight from device memory (no
per-tile payload table, so no capacity limit) and writes 32 attribute
planes with perspective-correct interpolation and analytic UV
derivatives.
"""

from __future__ import annotations

import torch

from ..kernels import build as K
from ..utils.timeline_trace import span
from .raster import TriangleSetup, pixel_centers
from .raster_binned import (
    SPAN_H, SPAN_W, TILE_H, TILE_W, bin_triangles, clamped_entries,
    plain_winners, walk_launch_args,
)

PAYLOAD_LO = 21       # payload lanes [21, 21 + 64)
EXTRA_COLS = 64

PLANE_DEPTH = 0
PLANE_COVERED = 1
PLANE_POS = 2         # 3
PLANE_NRM = 5         # 3
PLANE_TAN = 8         # 4
PLANE_UV = 12         # 2
PLANE_DUVDX = 14      # 2
PLANE_DUVDY = 16      # 2
PLANE_BASE = 18       # 4
PLANE_MR = 22         # 2
PLANE_BUNDLE = 24
PLANE_EMISSIVE = 25   # 3
PLANE_PREV = 28       # 3
NUM_PLANES = 32


def build_resolve_extra(scene, world_pos, world_normal, world_tangent,
                        prev_world_pos=None):
    """(T, 46|55) per-triangle payload: 3 corners x 12 attributes,
    material factors, bundle, emissive [, 3 corners x prev pos]."""
    T_ = scene.indices.shape[0]
    attrs = [world_pos, world_normal, world_tangent, scene.uvs]
    if prev_world_pos is not None:
        attrs.append(prev_world_pos)
    vattrs = torch.cat(attrs, dim=1)
    corner = vattrs[scene.indices.long()]              # (T, 3, A)
    mat = scene.tri_material.long()
    cols = [corner[..., 0:12].reshape(T_, 36),
            scene.mat_base_color[mat],
            scene.mat_mr[mat],
            scene.mat_bundle[mat].to(torch.float32)[:, None],
            scene.mat_emissive[mat]]
    if prev_world_pos is not None:
        cols.append(corner[..., 12:15].reshape(T_, 9))
    return torch.cat(cols, dim=1)


def fold_adjugate(setup: TriangleSetup):
    """lam = a*(px-ox) + b*(py-oy) + c == a*px + b*py + (c - a*ox - b*oy)."""
    adj = setup.adj
    ox = setup.offset[:, 0:1]
    oy = setup.offset[:, 1:2]
    c_folded = adj[..., 2] - adj[..., 0] * ox - adj[..., 1] * oy
    return torch.cat([adj[..., 0:1], adj[..., 1:2], c_folded[..., None]],
                     dim=-1)


def resolve_planes(payload, px, py, has_prev: bool):
    """Interpolate a per-pixel (64, ...) payload into the 32 planes, in
    the kernel's operation order (csrc/raster_fused.cu)."""
    v = payload
    a = [v[0], v[3], v[6]]
    b = [v[1], v[4], v[7]]
    c = [v[2], v[5], v[8]]
    lam = [a[i] * px + b[i] * py + c[i] for i in range(3)]
    D = lam[0] + lam[1] + lam[2]
    Dx = a[0] + a[1] + a[2]
    Dy = b[0] + b[1] + b[2]
    D = torch.where(D.abs() < 1e-20, torch.full_like(D, 1e-20), D)
    inv_d = 1.0 / D
    zero = torch.zeros_like(D)
    out = [None] * NUM_PLANES
    for k in range(12):
        c0, c1, c2 = v[9 + k], v[21 + k], v[33 + k]
        n = lam[0] * c0 + lam[1] * c1 + lam[2] * c2
        val = n * inv_d
        if k < 10:
            out[PLANE_POS + k] = val
        else:
            nx = a[0] * c0 + a[1] * c1 + a[2] * c2
            ny = b[0] * c0 + b[1] * c1 + b[2] * c2
            out[PLANE_UV + k - 10] = val
            out[PLANE_DUVDX + k - 10] = (nx - val * Dx) * inv_d
            out[PLANE_DUVDY + k - 10] = (ny - val * Dy) * inv_d
    for k in range(4):
        out[PLANE_BASE + k] = v[45 + k]
    out[PLANE_MR] = v[49]
    out[PLANE_MR + 1] = v[50]
    out[PLANE_BUNDLE] = v[51]
    for k in range(3):
        out[PLANE_EMISSIVE + k] = v[52 + k]
        out[PLANE_PREV + k] = ((lam[0] * v[55 + k] + lam[1] * v[58 + k]
                                + lam[2] * v[61 + k]) * inv_d
                               if has_prev else zero)
    out[NUM_PLANES - 1] = zero
    return out


def resolve_tiles_plain(starts, huge_row_starts, packets, huge_rows,
                        tiles_x: int, tiles_y: int, span_w: int,
                        span_h: int, has_prev: bool):
    """Plain PyTorch version of kernel B2 -> planes (32, ph, pw)."""
    depth, gid = plain_winners(starts, huge_row_starts, packets, huge_rows,
                               tiles_x, tiles_y, span_w, span_h)
    ph, pw = depth.shape
    covered = gid >= 0
    rows = torch.cat([packets, huge_rows])[
        gid.clamp_min(0).reshape(-1), PAYLOAD_LO:PAYLOAD_LO + EXTRA_COLS]
    rows = torch.where(covered.reshape(-1, 1), rows, torch.zeros_like(rows))
    payload = rows.T.reshape(EXTRA_COLS, ph, pw)
    px, py = pixel_centers(pw, ph, packets.device)
    planes = resolve_planes(payload, px, py, has_prev)
    planes[PLANE_DEPTH] = depth
    planes[PLANE_COVERED] = covered.to(torch.float32)
    return torch.stack(planes)


def resolve_tiles(starts, huge_row_starts, packets, huge_rows,
                  tiles_x: int, tiles_y: int, span_w: int, span_h: int,
                  has_prev: bool):
    """Kernel B2 (replaces granite_tpu/ops/raster_fused.py _fused_kernel):
    -> planes (32, ph, pw) f32 (see raster_binned.raster_tiles)."""
    dev = packets.device
    if dev.type == "cpu":
        return resolve_tiles_plain(starts, huge_row_starts, packets,
                                   huge_rows, tiles_x, tiles_y, span_w,
                                   span_h, has_prev)
    if dev.type != "cuda":
        raise ValueError(f"resolve_tiles: unsupported device {dev}")
    items, n_items, scratch, stride = walk_launch_args(
        "resolve_tiles", starts, huge_row_starts, packets, huge_rows,
        tiles_x, tiles_y, span_w, span_h)
    ph, pw = tiles_y * TILE_H, tiles_x * TILE_W
    planes = torch.empty((NUM_PLANES, ph, pw), dtype=torch.float32,
                         device=dev)
    K.launch("B2", "granite_raster_resolve", K.ptr(items), K.ptr(n_items),
             K.ptr(packets), K.ptr(huge_rows), K.ptr(scratch), K.ptr(planes),
             tiles_x, tiles_y, span_w * span_h, stride, int(has_prev))
    return planes


def rasterize_resolve(setup: TriangleSetup, extra, width: int,
                      height: int, huge_cap: int = 1024,
                      span_w: int = SPAN_W, span_h: int = SPAN_H,
                      has_prev: bool = False,
                      max_visible: int | None = None,
                      with_stats: bool = False):
    """Fused binned raster + resolve -> planes (32, H, W) [, stats]."""
    tx = -(-width // TILE_W)
    ty = -(-height // TILE_H)
    T_ = setup.adj.shape[0]
    with span("raster.bin"):
        adj9 = fold_adjugate(setup).reshape(T_, 9)
        payload = torch.cat([adj9, extra.to(torch.float32)], dim=1)
        packets, starts, huge_rows, huge_row_starts, stats = bin_triangles(
            setup, width, height, huge_cap, span_w=span_w, span_h=span_h,
            extra=payload, max_visible=max_visible)
    with span("raster.resolve"):
        planes = resolve_tiles(starts, huge_row_starts, packets, huge_rows,
                               tx, ty, span_w, span_h, has_prev)
        planes = planes[:, :height, :width]
        if with_stats:
            stats["max_bin_entries"] = (starts[1:] - starts[:-1]).max()
            stats["clamped_entries"] = clamped_entries(
                starts, huge_row_starts, tx, ty, span_w, span_h)
            return planes, stats
        return planes
