# Frozen copy of granite_tpu_torch/ops/raster.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""Clip-less homogeneous triangle setup + the classic brute-force raster
(port of granite_tpu/ops/raster.py).

Setup builds, per triangle, watertight canonical edge functions
(A, B, C, ex, ey) with E(p) = A*(px-ex) + B*(py-ey) + C, the sign-
normalized adjugate rows used for perspective-correct interpolation, a
z plane, and a conservative pixel bbox; near-plane-crossing triangles
fall back to homogeneous adjugate edges (Olano-Greer) with a full-screen
bbox.  Reverse-Z (near 1, far 0) with the GREATER test; Vulkan's
top-left fill rule; pixel centers at (x + 0.5, y + 0.5).

`rasterize` is the O(pixels x triangles) reference the binned kernels
(ops/raster_binned.py, ops/raster_fused.py) are tested against; the
scene renderer never calls it, the one-triangle demo
(app/triangle_demo.py) does, as the JAX demo does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CULL_NONE = 0
CULL_BACK = 1
CULL_FRONT = 2


class TriangleSetup(NamedTuple):
    adj: torch.Tensor       # (T, 3, 3) sign-normalized adjugate rows
    zplane: torch.Tensor    # (T, 3)
    offset: torch.Tensor    # (T, 2) per-triangle origin
    edge: torch.Tensor      # (T, 3, 5) (A, B, C, ex, ey)
    valid: torch.Tensor     # (T,) bool
    bbox: torch.Tensor      # (T, 4) int32 [x0, y0, x1, y1)


def setup_triangles(clip: torch.Tensor, indices: torch.Tensor, width: int,
                    height: int, cull_mode: int = CULL_BACK,
                    front_face_ccw: bool = True) -> TriangleSetup:
    """clip (V, 4) clip-space positions; indices (T, 3) int."""
    tri = clip[indices.long()]                    # (T, 3, 4)
    comp = tri.reshape(-1, 12).T                  # (12, T)
    xs = [comp[0], comp[4], comp[8]]
    ys = [comp[1], comp[5], comp[9]]
    zs = [comp[2], comp[6], comp[10]]
    ws = [comp[3], comp[7], comp[11]]

    sx = [(0.5 * xs[i] + 0.5 * ws[i]) * width for i in range(3)]
    sy = [(0.5 * ys[i] + 0.5 * ws[i]) * height for i in range(3)]

    w_ok = [w > 0 for w in ws]
    any_w_pos = w_ok[0] | w_ok[1] | w_ok[2]
    px, py = [], []
    zero = torch.zeros((), dtype=clip.dtype, device=clip.device)
    for i in range(3):
        wd = torch.where(ws[i].abs() < 1e-20,
                         torch.full_like(ws[i], 1e-20), ws[i])
        px.append(torch.where(w_ok[i], sx[i] / wd, zero))
        py.append(torch.where(w_ok[i], sy[i] / wd, zero))
    n_ok = (w_ok[0].int() + w_ok[1].int() + w_ok[2].int()).clamp_min(1)
    ox = torch.round((px[0] + px[1] + px[2]) / n_ok)
    oy = torch.round((py[0] + py[1] + py[2]) / n_ok)
    sx = [sx[i] - ox * ws[i] for i in range(3)]
    sy = [sy[i] - oy * ws[i] for i in range(3)]

    adj_rows = []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        ax = sy[j] * ws[k] - ws[j] * sy[k]
        ay = ws[j] * sx[k] - sx[j] * ws[k]
        az = sx[j] * sy[k] - sy[j] * sx[k]
        adj_rows.append([ax, ay, az])
    det = (sx[0] * adj_rows[0][0] + sy[0] * adj_rows[0][1]
           + ws[0] * adj_rows[0][2])

    is_front = (det < 0) if front_face_ccw else (det > 0)
    if cull_mode == CULL_BACK:
        facing_ok = is_front
    elif cull_mode == CULL_FRONT:
        facing_ok = ~is_front
    else:
        facing_ok = det != 0

    sgn = torch.where(det < 0, -1.0, 1.0).to(clip.dtype)
    adj_rows = [[c * sgn for c in row] for row in adj_rows]
    valid = facing_ok & (det != 0) & any_w_pos

    det_abs = torch.where(det == 0, torch.ones_like(det), det.abs())
    inv_det = 1.0 / det_abs
    zpl = [(zs[0] * adj_rows[0][c] + zs[1] * adj_rows[1][c]
            + zs[2] * adj_rows[2][c]) * inv_det for c in range(3)]

    crosses = ~(w_ok[0] & w_ok[1] & w_ok[2])
    idx_t = indices.T
    edge_comp = []
    orient_ok = None
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        swap = idx_t[j] > idx_t[k]
        pxj = torch.where(swap, px[k], px[j])
        pyj = torch.where(swap, py[k], py[j])
        qxj = torch.where(swap, px[j], px[k])
        qyj = torch.where(swap, py[j], py[k])
        A = pyj - qyj
        B = qxj - pxj
        ev = A * (px[i] - pxj) + B * (py[i] - pyj)
        orient = torch.sign(ev)
        ok = crosses | (ev != 0)
        orient_ok = ok if orient_ok is None else (orient_ok & ok)
        edge_comp.append(torch.where(crosses, adj_rows[i][0], orient * A))
        edge_comp.append(torch.where(crosses, adj_rows[i][1], orient * B))
        edge_comp.append(torch.where(crosses, adj_rows[i][2], zero))
        edge_comp.append(torch.where(crosses, ox, pxj))
        edge_comp.append(torch.where(crosses, oy, pyj))
    valid = valid & orient_ok

    pxmin = torch.minimum(torch.minimum(px[0], px[1]), px[2])
    pxmax = torch.maximum(torch.maximum(px[0], px[1]), px[2])
    pymin = torch.minimum(torch.minimum(py[0], py[1]), py[2])
    pymax = torch.maximum(torch.maximum(py[0], py[1]), py[2])
    x0 = torch.floor(pxmin - 0.5).clamp(0, width).to(torch.int32)
    y0 = torch.floor(pymin - 0.5).clamp(0, height).to(torch.int32)
    x1 = torch.ceil(pxmax + 0.5).clamp(0, width).to(torch.int32)
    y1 = torch.ceil(pymax + 0.5).clamp(0, height).to(torch.int32)
    izero = torch.zeros((), dtype=torch.int32, device=clip.device)
    x0 = torch.where(crosses, izero, x0)
    y0 = torch.where(crosses, izero, y0)
    x1 = torch.where(crosses, izero + width, x1)
    y1 = torch.where(crosses, izero + height, y1)
    valid = valid & (x1 > x0) & (y1 > y0)

    T_ = indices.shape[0]
    adj = torch.stack([c for row in adj_rows for c in row]).T.reshape(
        T_, 3, 3)
    zplane = torch.stack(zpl).T.contiguous()
    edge = torch.stack(edge_comp).T.reshape(T_, 3, 5)
    offset = torch.stack([ox, oy]).T.contiguous()
    bbox = torch.stack([x0, y0, x1, y1]).T.contiguous()
    return TriangleSetup(adj=adj.contiguous(), zplane=zplane, offset=offset,
                         edge=edge.contiguous(), valid=valid, bbox=bbox)


def edge_inside(lam, a, b):
    """Top-left rule: edges with a > 0 (left) or a == 0, b > 0 (top)
    include lam == 0; the others exclude it."""
    top_left = (a > 0) | ((a == 0) & (b > 0))
    return (lam > 0) | (top_left & (lam == 0))


def pixel_centers(width: int, height: int, device=None):
    """(H, W) grids of pixel-center coordinates."""
    px = (torch.arange(width, dtype=torch.float32, device=device)
          + 0.5)[None, :]
    py = (torch.arange(height, dtype=torch.float32, device=device)
          + 0.5)[:, None]
    return px.expand(height, width), py.expand(height, width)


def rasterize(setup: TriangleSetup, width: int, height: int,
              chunk: int = 8):
    """Brute-force rasterization of every triangle against every pixel
    (the reference for the binned kernels).  Returns (depth (H, W) f32
    reverse-Z, tri (H, W) int32, -1 = none); ties go to the lowest
    triangle index."""
    dev = setup.adj.device
    px, py = pixel_centers(width, height, dev)
    depth = torch.zeros((height, width), dtype=torch.float32, device=dev)
    tri = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    T = setup.adj.shape[0]
    for c0 in range(0, T, chunk):
        e = setup.edge[c0:c0 + chunk]
        zp = setup.zplane[c0:c0 + chunk]
        off = setup.offset[c0:c0 + chunk]
        ok = setup.valid[c0:c0 + chunk, None, None]
        cover = ok
        for k in range(3):
            a = e[:, k, 0, None, None]
            b = e[:, k, 1, None, None]
            lam = a * (px - e[:, k, 3, None, None]) \
                + b * (py - e[:, k, 4, None, None]) + e[:, k, 2, None, None]
            cover = cover & edge_inside(lam, a, b)
        z = zp[:, 0, None, None] * (px - off[:, 0, None, None]) \
            + zp[:, 1, None, None] * (py - off[:, 1, None, None]) \
            + zp[:, 2, None, None]
        cover = cover & (z >= 0.0) & (z <= 1.0)
        zc = torch.where(cover, z, torch.full_like(z, -1.0))
        best_z, best = zc.max(dim=0)
        hit = best_z > depth
        depth = torch.where(hit, best_z, depth)
        tri = torch.where(hit, best.to(torch.int32) + c0, tri)
    return depth, tri


def interpolate_with_derivs(attrs: torch.Tensor, indices: torch.Tensor,
                            tri: torch.Tensor, setup: TriangleSetup, px, py):
    """Perspective-correct interpolation of vertex attributes at every
    pixel, with analytic screen-space derivatives: u = N / D with N and D
    linear in screen space, so du/dx = (N_x D - N D_x) / D^2.  attrs (V,
    C); tri (H, W), -1 = none (those pixels take triangle 0's values).
    -> (value, du_dx, du_dy), each (H, W, C)."""
    t = tri.clamp_min(0).long()
    adj = setup.adj[t]                                   # (H, W, 3, 3)
    off = setup.offset[t]
    av = attrs[indices.long()[t]]                        # (H, W, 3, C)
    lam = (adj[..., 0] * (px - off[..., 0])[..., None]
           + adj[..., 1] * (py - off[..., 1])[..., None]
           + adj[..., 2])
    d = lam.sum(-1)
    dx = adj[..., 0].sum(-1)
    dy = adj[..., 1].sum(-1)
    n = (av * lam[..., None]).sum(-2)
    nx = (av * adj[..., 0][..., None]).sum(-2)
    ny = (av * adj[..., 1][..., None]).sum(-2)
    d = torch.where(d.abs() < 1e-20, torch.full_like(d, 1e-20), d)[..., None]
    val = n / d
    return val, (nx - val * dx[..., None]) / d, (ny - val * dy[..., None]) / d
