"""Visibility: a z-buffer over every triangle, with each triangle clipped
against the near plane first, and no bins, tiles or lists.

Everything is evaluated in float64.  Rules (Vulkan's, which the engine
states): pixel centres at (x + 0.5,
y + 0.5) with x = (x_ndc + 1) / 2 * width and y likewise; reverse-Z, so
the largest depth z_ndc = z / w wins and a pixel is drawn for 0 < z_ndc
<= 1; the top-left fill rule; on equal depths the lower triangle id
wins.  Each edge is evaluated from its endpoints in one fixed order
(lexicographic), so triangles that share an edge agree on every pixel
of it and the mesh stays watertight.
"""

from __future__ import annotations

import torch

# Candidate (triangle, pixel) pairs evaluated at once.
BUDGET = 1 << 24


def orientation(clip: torch.Tensor) -> torch.Tensor:
    """(T, 3, 4) -> sign of det[x_i, y_i, w_i] per triangle: negative for
    a front face (counter-clockwise on screen with Y down)."""
    m = clip[..., [0, 1, 3]].to(torch.float64)
    return torch.sign(torch.linalg.det(m))


def clip_triangles(clip: torch.Tensor, vid: torch.Tensor):
    """Clip triangles (T, 3, 4) against the near plane z <= w.  -> (sub
    (S, 3, 4) clip-space triangles, src (S,) the triangle each came
    from).  An edge's crossing point is computed from its endpoints in
    the order of their vertex ids vid (T, 3), so triangles that share the
    edge get the same point."""
    d = clip[..., 3] - clip[..., 2]                  # inside: d >= 0
    inside = d >= 0
    n_in = inside.sum(1)
    T = clip.shape[0]
    ar = torch.arange(T, device=clip.device)
    keep = n_in == 3
    subs = [clip[keep]]
    srcs = [ar[keep]]

    def cross(i, j, sel):
        """Crossing point of edge (i, j) (per-triangle slot tensors) of
        the triangles `sel`, from the lower vertex id to the higher."""
        a = clip[sel, i]
        b = clip[sel, j]
        da = d[sel, i]
        db = d[sel, j]
        swap = (vid[sel, i] > vid[sel, j])[:, None]
        p, q = torch.where(swap, b, a), torch.where(swap, a, b)
        dp = torch.where(swap[:, 0], db, da)
        dq = torch.where(swap[:, 0], da, db)
        t = (dp / (dp - dq))[:, None]
        return p + t * (q - p)

    for count in (1, 2):
        sel = torch.nonzero(n_in == count)[:, 0]
        if not len(sel):
            continue
        # k: the vertex alone on its side (inside for 1, outside for 2)
        lone = inside[sel] if count == 1 else ~inside[sel]
        k = lone.to(torch.int64).argmax(1)
        a, b, c = k, (k + 1) % 3, (k + 2) % 3
        va = clip[sel, a]
        vb = clip[sel, b]
        vc = clip[sel, c]
        if count == 1:            # a inside: (a, ab, ac)
            subs.append(torch.stack([va, cross(a, b, sel),
                                     cross(a, c, sel)], 1))
            srcs.append(sel)
        else:                     # a outside, b and c inside: a quad
            ab = cross(a, b, sel)
            ca = cross(c, a, sel)
            subs.append(torch.stack([vb, vc, ca], 1))
            subs.append(torch.stack([vb, ca, ab], 1))
            srcs += [sel, sel]
    return torch.cat(subs), torch.cat(srcs)


def _ceil_log2(x: torch.Tensor) -> torch.Tensor:
    return torch.ceil(torch.log2(x.to(torch.float64))).to(torch.int64)


def rasterize(clip: torch.Tensor, vid: torch.Tensor, width: int,
              height: int, cull_back: bool, tri_ids=None):
    """Z-buffer of triangles given in clip space.

    clip (T, 3, 4), vid (T, 3) vertex ids (for the clipper's edge order),
    cull_back: drop back faces (orientation() >= 0); tri_ids (T,) the ids
    reported (default 0..T-1).  -> (depth (H, W) float32, 0 where empty;
    tri (H, W) int64, -1 where empty)."""
    dev = clip.device
    T = clip.shape[0]
    if tri_ids is None:
        tri_ids = torch.arange(T, device=dev)
    ok = torch.ones(T, dtype=torch.bool, device=dev)
    if cull_back:
        ok &= orientation(clip) < 0
    clip, vid, tri_ids = clip[ok], vid[ok], tri_ids[ok]
    sub, src = clip_triangles(clip.to(torch.float64), vid)
    ids = tri_ids[src]
    w = sub[..., 3]
    sx = (0.5 * sub[..., 0] / w + 0.5) * width
    sy = (0.5 * sub[..., 1] / w + 0.5) * height
    sz = sub[..., 2] / w

    # signed doubled area; zero-area triangles cover nothing
    area = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) \
        - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0])
    x0 = torch.ceil(sx.min(1).values - 0.5).clamp(0, width).to(torch.int64)
    x1 = (torch.floor(sx.max(1).values - 0.5) + 1).clamp(0, width) \
        .to(torch.int64)
    y0 = torch.ceil(sy.min(1).values - 0.5).clamp(0, height).to(torch.int64)
    y1 = (torch.floor(sy.max(1).values - 0.5) + 1).clamp(0, height) \
        .to(torch.int64)
    live = (area != 0) & (x1 > x0) & (y1 > y0) & torch.isfinite(area)
    sel = torch.nonzero(live)[:, 0]
    sx, sy, sz, area, ids = sx[sel], sy[sel], sz[sel], area[sel], ids[sel]
    x0, x1, y0, y1 = x0[sel], x1[sel], y0[sel], y1[sel]
    sgn = torch.sign(area)

    # edges (1, 2), (2, 0), (0, 1): coefficients of E(p) = A px + B py + C
    # from the lexicographically lower endpoint, oriented so the inside is
    # positive, and whether the edge is top-left (E == 0 counts)
    edges = []
    for i, j in ((1, 2), (2, 0), (0, 1)):
        pxi, pyi, pxj, pyj = sx[:, i], sy[:, i], sx[:, j], sy[:, j]
        swap = (pxi > pxj) | ((pxi == pxj) & (pyi > pyj))
        px_, py_ = torch.where(swap, pxj, pxi), torch.where(swap, pyj, pyi)
        qx_, qy_ = torch.where(swap, pxi, pxj), torch.where(swap, pyi, pyj)
        s = torch.where(swap, -sgn, sgn)
        # E(p) = s * ((qx - px) (y - py) - (qy - py) (x - px))
        a = -s * (qy_ - py_)
        b = s * (qx_ - px_)
        top_left = (a > 0) | ((a == 0) & (b > 0))
        edges.append((px_, py_, qx_ - px_, qy_ - py_, s, top_left))

    key = torch.zeros(height * width, dtype=torch.int64, device=dev)
    cw = _ceil_log2(x1 - x0)
    ch = _ceil_log2(y1 - y0)
    for kw, kh in torch.unique(torch.stack([cw, ch], 1), dim=0).tolist():
        members = torch.nonzero((cw == kw) & (ch == kh))[:, 0]
        bw, bh = 1 << kw, 1 << kh
        step = max(BUDGET // (bw * bh), 1)
        ox = torch.arange(bw, device=dev)[None, None, :]
        oy = torch.arange(bh, device=dev)[None, :, None]
        for c0 in range(0, len(members), step):
            m = members[c0:c0 + step]
            px = x0[m, None, None] + ox                    # (n, 1, bw)
            py = y0[m, None, None] + oy                    # (n, bh, 1)
            inb = (px < x1[m, None, None]) & (py < y1[m, None, None])
            cx = px.to(torch.float64) + 0.5
            cy = py.to(torch.float64) + 0.5
            cover = inb
            lam = []
            for (epx, epy, dx, dy, s, tl) in edges:
                e = s[m, None, None] * (
                    dx[m, None, None] * (cy - epy[m, None, None])
                    - dy[m, None, None] * (cx - epx[m, None, None]))
                cover = cover & ((e > 0) | ((e == 0) & tl[m, None, None]))
                lam.append(e)
            tot = lam[0] + lam[1] + lam[2]
            z = (lam[0] * sz[m, 0, None, None] + lam[1] * sz[m, 1, None, None]
                 + lam[2] * sz[m, 2, None, None]) / tot
            cover = cover & (z > 0) & (z <= 1)
            flat = (py * width + px).expand_as(cover)[cover]
            zb = z[cover].to(torch.float32).view(torch.int32) \
                .to(torch.int64)
            tid = ids[m, None, None].expand_as(cover)[cover]
            k = (zb << 32) | (0xFFFFFFFF - tid)
            key.scatter_reduce_(0, flat, k, reduce="amax")
    hit = key > 0
    depth = torch.where(hit, (key >> 32).to(torch.int32).view(torch.float32),
                        torch.zeros((), device=dev))
    tri = torch.where(hit, 0xFFFFFFFF - (key & 0xFFFFFFFF),
                      torch.full((), -1, device=dev, dtype=torch.int64))
    return depth.reshape(height, width), tri.reshape(height, width)
