"""Binned tile rasterizer (port of granite_tpu/ops/raster_binned.py) with
kernel B1, the depth-only visibility buffer over 32x128 tiles.

Binning stays plain PyTorch (the reference ran it as XLA outside its
Pallas kernel): one composite key per small triangle, (bin << 19 |
quantized(1 - zmax)), sorted once, so every bin is a contiguous range of
128-lane packets ordered front to back.  Single-tile triangles key at
their tile (EXACT bins [0, ntiles)); multi-tile triangles within a
span_w x span_h window key at their top-left tile (WINDOW bins
[ntiles, 2*ntiles)); larger or near-plane-crossing triangles go to
per-tile-row HUGE lists.  The first row of every 16-row group carries
the group's tile-bbox union (COL_UNION_X/Y) so the kernel can skip
groups that cannot reach its tile.

B1 (`raster_tiles`) walks, per tile: its exact bin, the window bins
up-left of it, its row's huge list — in that order, each range front to
back — with reverse-Z GREATER, first hit winning ties, an early-z stop
per range and each range clamped to MAX_ENTRIES_PER_TILE (clamped
entries are counted in the stats, not dropped silently).  On a CUDA
tensor it launches csrc/raster_binned.cu; on a CPU tensor it runs
`raster_tiles_plain`, which evaluates the same (tile, packet) pairs
inside each triangle's bbox and merges them with a 64-bit key (depth
bits, then inverted walk order) through scatter_reduce(amax).
"""

from __future__ import annotations

import torch

from ..kernels import build as K
from .raster import TriangleSetup

TILE_H = 32
TILE_W = 128
SPAN_W = 2
SPAN_H = 4
PACKET_F32 = 128
CHUNK = 16
MAX_ENTRIES_PER_TILE = 65536
COL_TRI = 20
COL_ZMAX = 120
# Pixel bbox [x0, y0, x1, y1) of the packet's triangle (integer-valued
# floats).  The reference leaves these lanes zero; the plain versions
# use them to evaluate only pixels a triangle can cover.
COL_BBOX = 121
COL_UNION_X = 126          # min_tx + max_tx * 2048
COL_UNION_Y = 127          # min_ty + max_ty * 2048
UNION_SHIFT = 11
ZQ_BITS = 19
ZQ_MAX = (1 << ZQ_BITS) - 1
ZQ_PAD = 2.0 ** -(ZQ_BITS - 1)


def _zq_key(zmax: torch.Tensor) -> torch.Tensor:
    """Ascending int32 key: nearest (largest reverse-Z zmax) first."""
    z = torch.nan_to_num(1.0 - zmax, nan=1.0, posinf=1.0, neginf=0.0)
    return (z.clamp(0.0, 1.0) * ZQ_MAX).to(torch.int32)


def _tri_zmax(setup: TriangleSetup) -> torch.Tensor:
    """(T,) conservative max reverse-Z depth over the triangle's bbox."""
    g0, g1, g2 = setup.zplane[:, 0], setup.zplane[:, 1], setup.zplane[:, 2]
    ox, oy = setup.offset[:, 0], setup.offset[:, 1]
    bb = setup.bbox.to(torch.float32)
    zm = None
    for xi, yi in ((0, 1), (2, 1), (0, 3), (2, 3)):
        z = g0 * (bb[:, xi] - ox) + g1 * (bb[:, yi] - oy) + g2
        zm = z if zm is None else torch.maximum(zm, z)
    return zm.clamp_max(1.0)


def _build_packets(setup: TriangleSetup, extra=None) -> torch.Tensor:
    """(T, 128) f32 packets: edges 0-14, z plane 15-17, offset 18-19,
    tri id (int32 bits) 20, resolve payload from 21, zmax 120, pixel
    bbox 121-124; union lanes 126/127 are filled after sorting."""
    T = setup.adj.shape[0]
    dev = setup.adj.device
    ids = torch.arange(T, dtype=torch.int32, device=dev).view(torch.float32)
    pk = torch.zeros((T, PACKET_F32), dtype=torch.float32, device=dev)
    pk[:, 0:15] = setup.edge.reshape(T, 15)
    pk[:, 15:18] = setup.zplane
    pk[:, 18:20] = setup.offset
    pk[:, COL_TRI] = ids
    if extra is not None:
        if 21 + extra.shape[1] > COL_ZMAX:
            raise ValueError("resolve payload wider than the packet")
        pk[:, 21:21 + extra.shape[1]] = extra.to(torch.float32)
    pk[:, COL_ZMAX] = _tri_zmax(setup)
    pk[:, COL_BBOX:COL_BBOX + 4] = setup.bbox.to(torch.float32)
    return pk


def _tile_rects(bbox):
    """Pixel bbox (T, 4) -> inclusive tile rect (tx0, ty0, tx1, ty1);
    empty bboxes give tx1 < tx0."""
    return (torch.div(bbox[:, 0], TILE_W, rounding_mode="floor"),
            torch.div(bbox[:, 1], TILE_H, rounding_mode="floor"),
            torch.div(bbox[:, 2] - 1, TILE_W, rounding_mode="floor"),
            torch.div(bbox[:, 3] - 1, TILE_H, rounding_mode="floor"))


def _chunk_union_cols(n: int, tx0, ty0, tx1, ty1, valid_key):
    """Per-16-row-group tile-bbox unions packed lo + (hi << 11) as
    integer-valued floats, placed on each group's first row (zeros on
    the other rows).  Returns two (n,) columns."""
    g = -(-n // CHUNK)
    dev = tx0.device
    big = 1 << 14

    def grp(v, red, empty):
        v = torch.where(valid_key, v, torch.full_like(v, empty))
        v = torch.cat([v, torch.full((g * CHUNK - n,), empty,
                                     dtype=v.dtype, device=dev)])
        return red(v.reshape(g, CHUNK), dim=1).values

    ux0 = grp(tx0, torch.min, big).clamp_max(2047)
    uy0 = grp(ty0, torch.min, big).clamp_max(2047)
    ux1 = grp(tx1, torch.max, -1).clamp_min(0)
    uy1 = grp(ty1, torch.max, -1).clamp_min(0)
    px = (ux0 + (ux1 << UNION_SHIFT)).to(torch.float32)
    py = (uy0 + (uy1 << UNION_SHIFT)).to(torch.float32)

    def col(vals):
        c = torch.zeros((g, CHUNK), dtype=torch.float32, device=dev)
        c[:, 0] = vals
        return c.reshape(-1)[:n]

    return col(px), col(py)


def bin_triangles(setup: TriangleSetup, width: int, height: int,
                  huge_cap: int = 1024, max_visible: int | None = None,
                  span_w: int = SPAN_W, span_h: int = SPAN_H, extra=None):
    """Sort-based binning.  Returns (packets (C+16, 128), starts
    (2*ntiles+1,) int32, huge_rows (alloc*ty+16, 128), huge_row_starts
    (ty+1,) int32, stats).

    stats (0-dim int tensors): visible_overflow (small triangles dropped
    by the max_visible compaction), exact_entries, window_entries,
    huge_overflow (huge triangles beyond huge_cap) — geometry is never
    dropped without a count."""
    tx = -(-width // TILE_W)
    ty = -(-height // TILE_H)
    ntiles = tx * ty
    if ntiles >= (1 << 11):
        raise ValueError("composite sort key needs ntiles < 2048")
    dev = setup.adj.device
    T = setup.adj.shape[0]
    zq_f = _zq_key(_tri_zmax(setup))
    valid = setup.valid
    tx0_f, ty0_f, tx1_f, ty1_f = _tile_rects(setup.bbox)
    sw_f = tx1_f - tx0_f + 1
    sh_f = ty1_f - ty0_f + 1
    small_f = valid & (sw_f <= span_w) & (sh_f <= span_h)
    huge = valid & ~small_f
    single_f = small_f & (sw_f == 1) & (sh_f == 1)
    bin_id = ty0_f * tx + tx0_f
    pop_bin = torch.where(single_f, bin_id, ntiles + bin_id)
    invalid_key = (2 * ntiles) << ZQ_BITS
    key_f = torch.where(small_f, (pop_bin << ZQ_BITS) | zq_f,
                        torch.full_like(zq_f, invalid_key)).to(torch.int32)
    arange_t = torch.arange(T, dtype=torch.int32, device=dev)
    stats = {}
    if max_visible is not None and max_visible < T:
        C = max_visible
        vpos = torch.cumsum(small_f.to(torch.int32), 0) - 1
        sel = small_f & (vpos < C)
        stats["visible_overflow"] = small_f.sum() - sel.sum()
        stats["exact_entries"] = (single_f & sel).sum()
        stats["window_entries"] = (sel & ~single_f).sum()
        dst = vpos[sel].long()
        keys = torch.full((C + CHUNK,), invalid_key, dtype=torch.int32,
                          device=dev)
        keys[dst] = key_f[sel]
        src = torch.zeros((C + CHUNK,), dtype=torch.int32, device=dev)
        src[dst] = arange_t[sel]
    else:
        stats["visible_overflow"] = torch.zeros((), dtype=torch.int64,
                                                device=dev)
        stats["exact_entries"] = single_f.sum()
        stats["window_entries"] = (small_f & ~single_f).sum()
        keys = torch.cat([key_f, torch.full((CHUNK,), invalid_key,
                                            dtype=torch.int32, device=dev)])
        src = torch.cat([arange_t, torch.zeros((CHUNK,), dtype=torch.int32,
                                               device=dev)])
    order = torch.sort(keys, stable=True).indices
    sorted_keys = keys[order] >> ZQ_BITS
    fidx = src[order].long()

    ux, uy = _chunk_union_cols(
        fidx.shape[0], tx0_f[fidx], ty0_f[fidx], tx1_f[fidx], ty1_f[fidx],
        sorted_keys < 2 * ntiles)
    base = _build_packets(setup, extra)
    packets = base[fidx]
    packets[:, COL_UNION_X] = ux
    packets[:, COL_UNION_Y] = uy
    starts = torch.searchsorted(
        sorted_keys.contiguous(),
        torch.arange(2 * ntiles + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)

    # --- huge: fixed-capacity compaction + per-tile-row lists -----------
    hidx = torch.cumsum(huge.to(torch.int32), 0) - 1
    hsel = huge & (hidx < huge_cap)
    alloc = -(-max(huge_cap, 1) // CHUNK) * CHUNK
    hdst = hidx[hsel].long()
    hsrc = torch.zeros((alloc,), dtype=torch.int64, device=dev)
    hsrc[hdst] = arange_t[hsel].long()
    trects = torch.stack([tx0_f, ty0_f, tx1_f, ty1_f], dim=1)
    hbb = torch.full((alloc, 4), -1, dtype=trects.dtype, device=dev)
    hbb[hdst] = trects[hsel]
    hzq = torch.full((alloc,), ZQ_MAX, dtype=torch.int32, device=dev)
    hzq[hdst] = zq_f[hsel]
    n_huge = huge.sum()
    huge_count = torch.clamp_max(n_huge, huge_cap)
    stats["huge_overflow"] = torch.clamp_min(n_huge - huge_cap, 0)

    htx0 = hbb[:, 0].clamp(0, tx - 1)
    htx1 = hbb[:, 2].clamp(0, tx - 1)
    hty0 = hbb[:, 1].clamp(0, ty - 1)
    hty1 = hbb[:, 3].clamp(0, ty - 1)
    live = (torch.arange(alloc, device=dev) < huge_count) \
        & (hbb[:, 3] >= hbb[:, 1]) & (hbb[:, 1] >= 0)
    rows = torch.arange(ty, dtype=torch.int32, device=dev)[None, :]
    pair_mask = live[:, None] & (rows >= hty0[:, None]) \
        & (rows <= hty1[:, None])
    pair_keys = torch.where(
        pair_mask, (rows << ZQ_BITS) | hzq[:, None],
        torch.full_like(pair_mask, ty << ZQ_BITS, dtype=torch.int32)
    ).reshape(-1)
    pair_keys = torch.cat([pair_keys, torch.full(
        (CHUNK,), ty << ZQ_BITS, dtype=torch.int32, device=dev)])
    order_h = torch.sort(pair_keys, stable=True).indices
    pair_slot = torch.clamp_max(
        torch.div(order_h, ty, rounding_mode="floor"), alloc - 1)
    sorted_rows = pair_keys[order_h] >> ZQ_BITS
    hux, huy = _chunk_union_cols(
        pair_slot.shape[0], htx0[pair_slot], hty0[pair_slot],
        htx1[pair_slot], hty1[pair_slot], sorted_rows < ty)
    huge_rows = base[hsrc][pair_slot]
    huge_rows[:, COL_UNION_X] = hux
    huge_rows[:, COL_UNION_Y] = huy
    huge_row_starts = torch.searchsorted(
        sorted_rows.contiguous(),
        torch.arange(ty + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    return packets, starts, huge_rows, huge_row_starts, stats


def scan_ranges(starts, huge_row_starts, tiles_x: int, tiles_y: int,
                span_w: int, span_h: int):
    """The ranges each tile walks, in walk order: (S, ntiles) starts and
    UNCLAMPED counts, plus a per-segment flag telling huge-list segments
    apart.  Segment 0 is the exact bin, then the window bins (wy, wx),
    last the tile row's huge list."""
    ntiles = tiles_x * tiles_y
    dev = starts.device
    t = torch.arange(ntiles, device=dev)
    tyi = torch.div(t, tiles_x, rounding_mode="floor")
    txi = t - tyi * tiles_x
    st = starts.long()
    seg_start = [st[t]]
    seg_count = [st[t + 1] - st[t]]
    for wy in range(span_h):
        for wx in range(span_w):
            by = tyi - wy
            bx = txi - wx
            ok = (by >= 0) & (bx >= 0)
            b = ntiles + by.clamp_min(0) * tiles_x + bx.clamp_min(0)
            seg_start.append(st[b])
            seg_count.append(torch.where(ok, st[b + 1] - st[b],
                                         torch.zeros_like(b)))
    hs = huge_row_starts.long()
    seg_start.append(hs[tyi])
    seg_count.append(hs[tyi + 1] - hs[tyi])
    is_huge = [False] * (len(seg_start) - 1) + [True]
    return torch.stack(seg_start), torch.stack(seg_count), is_huge


def clamped_entries(starts, huge_row_starts, tiles_x: int, tiles_y: int,
                    span_w: int, span_h: int) -> torch.Tensor:
    """Entries the walk skips because a range exceeds
    MAX_ENTRIES_PER_TILE, summed over every (tile, range)."""
    _, counts, _ = scan_ranges(starts, huge_row_starts, tiles_x, tiles_y,
                               span_w, span_h)
    return (counts - MAX_ENTRIES_PER_TILE).clamp_min(0).sum()


# Candidate (pixel, packet) evaluations per plain-version batch.
_PLAIN_BATCH = 1 << 22


def plain_winners(starts, huge_row_starts, packets, huge_rows,
                  tiles_x: int, tiles_y: int, span_w: int, span_h: int):
    """The tile walk's result without the walk: every (tile, packet)
    pair the kernel visits is evaluated on the pixels of the packet's
    bbox inside the tile, and pixels keep the maximum of a 64-bit key
    (depth bits << 32 | ~walk ordinal), i.e. the nearest hit with the
    first-visited packet winning ties — what the sequential walk with
    its strict GREATER test computes.  Early-z stops change nothing
    (they only skip packets that cannot pass the test).

    Returns (depth (ph, pw) f32, gid (ph, pw) int64): gid is the winning
    packet row, offset by packets.shape[0] for huge-list rows; -1 where
    nothing covers."""
    dev = packets.device
    ph, pw = tiles_y * TILE_H, tiles_x * TILE_W
    seg_start, seg_count, is_huge = scan_ranges(
        starts, huge_row_starts, tiles_x, tiles_y, span_w, span_h)
    seg_count = seg_count.clamp_max(MAX_ENTRIES_PER_TILE)
    n_small = packets.shape[0]
    stride = max(n_small, huge_rows.shape[0], 1)
    ntiles = tiles_x * tiles_y
    tile_ids = torch.arange(ntiles, device=dev)
    keys = torch.zeros(ph * pw, dtype=torch.int64, device=dev)
    lo_mask = (1 << 32) - 1

    for s in range(seg_start.shape[0]):
        counts = seg_count[s]
        total = int(counts.sum())
        if total == 0:
            continue
        arr = huge_rows if is_huge[s] else packets
        tile = torch.repeat_interleave(tile_ids, counts)
        first = torch.cumsum(counts, 0) - counts
        offs = torch.arange(total, device=dev) \
            - torch.repeat_interleave(first, counts)
        row = torch.repeat_interleave(seg_start[s], counts) + offs
        bb = arr[row, COL_BBOX:COL_BBOX + 4].to(torch.int64)
        tyi = torch.div(tile, tiles_x, rounding_mode="floor")
        tx0 = (tile - tyi * tiles_x) * TILE_W
        ty0 = tyi * TILE_H
        lx = torch.maximum(bb[:, 0], tx0)
        hx = torch.minimum(bb[:, 2], tx0 + TILE_W)
        ly = torch.maximum(bb[:, 1], ty0)
        hy = torch.minimum(bb[:, 3], ty0 + TILE_H)
        keep = (hx > lx) & (hy > ly)
        row, lx, hx, ly, hy = row[keep], lx[keep], hx[keep], ly[keep], \
            hy[keep]
        if row.numel() == 0:
            continue
        ordinal = s * stride + row
        pk = arr[row, :20]
        w = hx - lx
        area = w * (hy - ly)
        cum = torch.cumsum(area, 0)
        n_cand = int(cum[-1])
        # batch boundaries on whole pairs, ~_PLAIN_BATCH candidates each
        bounds = torch.searchsorted(
            cum, torch.tensor(list(range(_PLAIN_BATCH, n_cand,
                                         _PLAIN_BATCH)),
                              dtype=cum.dtype, device=dev),
            right=True).tolist()
        for p0, p1 in zip([0] + bounds, bounds + [row.shape[0]]):
            if p1 <= p0:
                continue
            ar = area[p0:p1]
            n = int(ar.sum())
            pair = torch.repeat_interleave(
                torch.arange(p0, p1, device=dev), ar)
            local = torch.arange(n, device=dev) \
                - torch.repeat_interleave(torch.cumsum(ar, 0) - ar, ar)
            wi = w[pair]
            xi = lx[pair] + local % wi
            yi = ly[pair] + torch.div(local, wi, rounding_mode="floor")
            px = xi.to(torch.float32) + 0.5
            py = yi.to(torch.float32) + 0.5
            c = pk[pair]
            cover = None
            for e in range(3):
                a = c[:, e * 5]
                b = c[:, e * 5 + 1]
                lam = a * (px - c[:, e * 5 + 3]) \
                    + b * (py - c[:, e * 5 + 4]) + c[:, e * 5 + 2]
                top_left = (a > 0) | ((a == 0) & (b > 0))
                ok = (lam > 0) | (top_left & (lam == 0))
                cover = ok if cover is None else (cover & ok)
            z = c[:, 15] * (px - c[:, 18]) + c[:, 16] * (py - c[:, 19]) \
                + c[:, 17]
            # hit needs z > depth >= 0: z == 0 never wins.
            cover = cover & (z > 0.0) & (z <= 1.0)
            if not bool(cover.any()):
                continue
            zbits = z[cover].contiguous().view(torch.int32).to(torch.int64)
            key = (zbits << 32) | (lo_mask - ordinal[pair[cover]])
            pix = yi[cover] * pw + xi[cover]
            keys.scatter_reduce_(0, pix, key, reduce="amax")

    hit = keys > 0
    depth = (keys >> 32).to(torch.int32).view(torch.float32)
    depth = torch.where(hit, depth, torch.zeros_like(depth))
    ordinal = lo_mask - (keys & lo_mask)
    seg = torch.div(ordinal, stride, rounding_mode="floor")
    row = ordinal - seg * stride
    huge_seg = len(is_huge) - 1
    gid = torch.where(seg == huge_seg, row + n_small, row)
    gid = torch.where(hit, gid, torch.full_like(gid, -1))
    return depth.reshape(ph, pw), gid.reshape(ph, pw)


def raster_tiles_plain(starts, huge_row_starts, packets, huge_rows,
                       tiles_x: int, tiles_y: int, span_w: int,
                       span_h: int):
    """Plain PyTorch version of kernel B1 (see plain_winners)."""
    depth, gid = plain_winners(starts, huge_row_starts, packets, huge_rows,
                               tiles_x, tiles_y, span_w, span_h)
    ids = torch.cat([packets[:, COL_TRI], huge_rows[:, COL_TRI]]) \
        .contiguous().view(torch.int32)
    tri = torch.where(gid >= 0, ids[gid.clamp_min(0)],
                      torch.full_like(gid, -1, dtype=torch.int32))
    return depth, tri.to(torch.int32)


def raster_tiles(starts, huge_row_starts, packets, huge_rows,
                 tiles_x: int, tiles_y: int, span_w: int, span_h: int):
    """Kernel B1 (replaces granite_tpu/ops/raster_binned.py
    _raster_tile_kernel): -> depth (ph, pw) f32, tri (ph, pw) int32.
    Only the viewport (the setup's width x height) is specified: the
    kernel also rasterizes the tile padding past it, the plain version
    leaves that padding clear."""
    dev = packets.device
    if dev.type == "cpu":
        return raster_tiles_plain(starts, huge_row_starts, packets,
                                  huge_rows, tiles_x, tiles_y, span_w,
                                  span_h)
    if dev.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {dev}")
    ntiles = tiles_x * tiles_y
    K.check(starts, "starts", torch.int32, dev, 1)
    K.check(huge_row_starts, "huge_row_starts", torch.int32, dev, 1)
    K.check(packets, "packets", torch.float32, dev, 2)
    K.check(huge_rows, "huge_rows", torch.float32, dev, 2)
    if starts.shape[0] != 2 * ntiles + 1 or \
            huge_row_starts.shape[0] != tiles_y + 1 or \
            packets.shape[1] != PACKET_F32 or \
            huge_rows.shape[1] != PACKET_F32:
        raise ValueError("raster_tiles: inconsistent bin arrays")
    ph, pw = tiles_y * TILE_H, tiles_x * TILE_W
    depth = torch.empty((ph, pw), dtype=torch.float32, device=dev)
    tri = torch.empty((ph, pw), dtype=torch.int32, device=dev)
    K.launch("B1", "granite_raster_binned", K.ptr(starts),
             K.ptr(huge_row_starts), K.ptr(packets), K.ptr(huge_rows),
             K.ptr(depth), K.ptr(tri), tiles_x, tiles_y, span_w, span_h)
    return depth, tri


def rasterize_binned(setup: TriangleSetup, width: int, height: int,
                     huge_cap: int = 1024, max_visible: int | None = None,
                     span_w: int = SPAN_W, span_h: int = SPAN_H,
                     with_stats: bool = False):
    """Full binned rasterization -> (depth (H, W), tri (H, W))
    [, stats].  stats adds max_bin_entries and clamped_entries to the
    binner's overflow counters."""
    tx = -(-width // TILE_W)
    ty = -(-height // TILE_H)
    packets, starts, huge_rows, huge_row_starts, stats = bin_triangles(
        setup, width, height, huge_cap, max_visible=max_visible,
        span_w=span_w, span_h=span_h)
    depth, tri = raster_tiles(starts, huge_row_starts, packets, huge_rows,
                              tx, ty, span_w, span_h)
    if with_stats:
        stats["max_bin_entries"] = (starts[1:] - starts[:-1]).max()
        stats["clamped_entries"] = clamped_entries(
            starts, huge_row_starts, tx, ty, span_w, span_h)
        return depth[:height, :width], tri[:height, :width], stats
    return depth[:height, :width], tri[:height, :width]
