"""Binned tile rasterizer (port of granite_tpu/ops/raster_binned.py) with
kernel B1, the depth-only visibility buffer over 32x128 tiles.

Binning stays plain PyTorch (the reference ran it as XLA outside its
Pallas kernel): one composite key per small triangle, (bin << 19 |
quantized(1 - zmax)), sorted once, so every bin is a contiguous range of
128-lane packets ordered front to back.  Single-tile triangles key at
their tile (EXACT bins [0, ntiles)); multi-tile triangles within a
span_w x span_h window key at their top-left tile (WINDOW bins
[ntiles, 2*ntiles)); larger or near-plane-crossing triangles go to
per-tile-row HUGE lists.  Every packet carries its triangle's pixel bbox
(COL_BBOX), which the kernels and the plain versions use to evaluate
only the pixels a triangle can cover.

Each tile walks its exact bin, the window bins up-left of it, its row's
huge list — in that order, each range front to back and clamped to
MAX_ENTRIES_PER_TILE (clamped entries are counted in the stats, not
dropped silently) — with reverse-Z GREATER and the first hit winning
ties.  `walk_items` cuts those ranges into slices of at most WALK_SLICE
packets, the work list of the kernels (csrc/raster_walk.cu); each slice
is walked on its own and the slices merge per pixel through the 64-bit
key (depth bits << 32 | ~walk ordinal), whose maximum is the sequential
walk's result.  `plain_keys` evaluates a work list the same way in
plain PyTorch (scatter_reduce amax); the plain versions (`plain_winners`)
evaluate the unsliced walk from `scan_ranges`, apart from the work list.
`raster_tiles` (B1) launches the kernel on a CUDA tensor or runs
`raster_tiles_plain` on a CPU one.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build as K
from ..utils.timeline_trace import readback
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
# floats, inside the viewport).  The reference leaves these lanes zero;
# the kernels and the plain versions evaluate only pixels inside it.
COL_BBOX = 121
# Packets a slice of the walk holds at most (csrc/raster_walk.cu stages
# them 64 at a time): short enough that the longest bin of the bench
# frames (~9.4k entries) spreads over ~74 blocks, and that the few long
# lists of large triangles of a light's view spread too.
WALK_SLICE = 128
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
    bbox 121-124."""
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
        # Each boolean-mask index below reads its count back to the host.
        with readback("bin.visible_dst", sel):
            dst = vpos[sel].long()
        keys = torch.full((C + CHUNK,), invalid_key, dtype=torch.int32,
                          device=dev)
        with readback("bin.visible_keys", sel):
            keys[dst] = key_f[sel]
        src = torch.zeros((C + CHUNK,), dtype=torch.int32, device=dev)
        with readback("bin.visible_src", sel):
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

    base = _build_packets(setup, extra)
    packets = base[fidx]
    starts = torch.searchsorted(
        sorted_keys.contiguous(),
        torch.arange(2 * ntiles + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)

    # --- huge: fixed-capacity compaction + per-tile-row lists -----------
    hidx = torch.cumsum(huge.to(torch.int32), 0) - 1
    hsel = huge & (hidx < huge_cap)
    alloc = -(-max(huge_cap, 1) // CHUNK) * CHUNK
    with readback("bin.huge_dst", hsel):
        hdst = hidx[hsel].long()
    hsrc = torch.zeros((alloc,), dtype=torch.int64, device=dev)
    with readback("bin.huge_src", hsel):
        hsrc[hdst] = arange_t[hsel].long()
    trects = torch.stack([tx0_f, ty0_f, tx1_f, ty1_f], dim=1)
    hbb = torch.full((alloc, 4), -1, dtype=trects.dtype, device=dev)
    with readback("bin.huge_rects", hsel):
        hbb[hdst] = trects[hsel]
    hzq = torch.full((alloc,), ZQ_MAX, dtype=torch.int32, device=dev)
    with readback("bin.huge_zq", hsel):
        hzq[hdst] = zq_f[hsel]
    n_huge = huge.sum()
    huge_count = torch.clamp_max(n_huge, huge_cap)
    stats["huge_overflow"] = torch.clamp_min(n_huge - huge_cap, 0)

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
    huge_rows = base[hsrc][pair_slot]
    huge_row_starts = torch.searchsorted(
        sorted_rows.contiguous(),
        torch.arange(ty + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    return packets, starts, huge_rows, huge_row_starts, stats


@functools.lru_cache(maxsize=32)
def _range_index(tiles_x: int, tiles_y: int, span_w: int, span_h: int,
                 device: torch.device):
    """Where each range of the walk starts and ends in cat([starts,
    huge_row_starts]): two (ntiles, S) int64 index tensors, tile-major.
    Window bins up-left of the target are empty (both ends index one
    entry).  They depend on the shapes only, so they are built once."""
    ntiles = tiles_x * tiles_y
    t = torch.arange(ntiles)
    tyi = torch.div(t, tiles_x, rounding_mode="floor")
    txi = t - tyi * tiles_x
    lo, hi = [t], [t + 1]
    for wy in range(span_h):
        for wx in range(span_w):
            by = tyi - wy
            bx = txi - wx
            b = ntiles + by.clamp_min(0) * tiles_x + bx.clamp_min(0)
            lo.append(b)
            hi.append(torch.where((by >= 0) & (bx >= 0), b + 1, b))
    lo.append(2 * ntiles + 1 + tyi)
    hi.append(2 * ntiles + 2 + tyi)
    return (torch.stack(lo, 1).to(device), torch.stack(hi, 1).to(device))


def _walk_ranges(starts, huge_row_starts, tiles_x: int, tiles_y: int,
                 span_w: int, span_h: int):
    """The kernels' gather of the walk's ranges through the cached
    `_range_index`: tile-major (ntiles * S,) first rows and UNCLAMPED
    counts."""
    lo, hi = _range_index(tiles_x, tiles_y, span_w, span_h, starts.device)
    ends = torch.cat([starts, huge_row_starts]).long()
    first = ends[lo]
    return first.reshape(-1), (ends[hi] - first).reshape(-1)


def scan_ranges(starts, huge_row_starts, tiles_x: int, tiles_y: int,
                span_w: int, span_h: int):
    """The ranges each tile walks, in walk order: (S, ntiles) starts and
    UNCLAMPED counts, S = 2 + span_w * span_h.  Segment 0 is the exact
    bin, then the window bins (wy, wx), last (S - 1) the tile row's huge
    list.  Computed bin by bin, apart from `_walk_ranges`, so that the
    plain versions enumerate the walk independently of the kernels' work
    list."""
    ntiles = tiles_x * tiles_y
    t = torch.arange(ntiles, device=starts.device)
    tyi = torch.div(t, tiles_x, rounding_mode="floor")
    txi = t - tyi * tiles_x
    st = starts.long()
    seg_start = [st[t]]
    seg_count = [st[t + 1] - st[t]]
    for wy in range(span_h):
        for wx in range(span_w):
            by = tyi - wy
            bx = txi - wx
            b = ntiles + by.clamp_min(0) * tiles_x + bx.clamp_min(0)
            seg_start.append(st[b])
            seg_count.append(torch.where((by >= 0) & (bx >= 0),
                                         st[b + 1] - st[b],
                                         torch.zeros_like(b)))
    hs = huge_row_starts.long()
    seg_start.append(hs[tyi])
    seg_count.append(hs[tyi + 1] - hs[tyi])
    return torch.stack(seg_start), torch.stack(seg_count)


def clamped_entries(starts, huge_row_starts, tiles_x: int, tiles_y: int,
                    span_w: int, span_h: int) -> torch.Tensor:
    """Entries the walk skips because a range exceeds
    MAX_ENTRIES_PER_TILE, summed over every (tile, range)."""
    _, counts = _walk_ranges(starts, huge_row_starts, tiles_x, tiles_y,
                             span_w, span_h)
    return (counts - MAX_ENTRIES_PER_TILE).clamp_min(0).sum()


def walk_items(starts, huge_row_starts, tiles_x: int, tiles_y: int,
               span_w: int, span_h: int, n_small: int, n_huge: int,
               slice_len: int = WALK_SLICE,
               max_entries: int = MAX_ENTRIES_PER_TILE):
    """The walk cut into slices: -> (items (capacity, 4) int32 rows
    [tile, segment, first packet row, packet count], n_items (1,) int32).

    Every (tile, segment) range of the walk (as `scan_ranges` lists
    them), clamped to max_entries, becomes ceil(count / slice_len) items
    in walk order.  Built with device ops only (no host sync): capacity
    is a bound from the array shapes (a small-packet row is walked by at
    most span_w * span_h tiles, a huge-list row by tiles_x), the first
    n_items rows are the work list and the rest are zero."""
    ntiles = tiles_x * tiles_y
    n_seg = 2 + span_w * span_h
    first, count = _walk_ranges(starts, huge_row_starts, tiles_x, tiles_y,
                                span_w, span_h)
    dev = first.device
    count = count.clamp_max(max_entries)
    n_slices = torch.div(count + slice_len - 1, slice_len,
                         rounding_mode="floor")
    cum = torch.cumsum(n_slices, 0)
    visits = span_w * span_h * n_small + tiles_x * n_huge
    capacity = -(-min(visits, ntiles * n_seg * max_entries) // slice_len) \
        + ntiles * n_seg
    idx = torch.arange(capacity, device=dev)
    pair = torch.searchsorted(cum, idx, right=True).clamp_max(
        cum.shape[0] - 1)
    k = idx - (cum[pair] - n_slices[pair])
    live = idx < cum[-1]
    rows = (count[pair] - k * slice_len).clamp(0, slice_len)
    items = torch.stack([
        torch.div(pair, n_seg, rounding_mode="floor"), pair % n_seg,
        first[pair] + k * slice_len, rows]).T
    items = torch.where(live[:, None], items, torch.zeros_like(items))
    return items.to(torch.int32).contiguous(), \
        cum[-1:].to(torch.int32).contiguous()


def ordinal_stride(n_small: int, n_huge: int, span_w: int,
                   span_h: int) -> int:
    """Walk ordinal = segment * stride + packet row; raises when the
    ordinals do not fit the key's low 32 bits."""
    stride = max(n_small, n_huge, 1)
    if (2 + span_w * span_h) * stride >= (1 << 32) - 1:
        raise ValueError("walk ordinals overflow 32 bits")
    return stride


# Candidate (pixel, packet) evaluations per plain-version batch.
_PLAIN_BATCH = 1 << 22
_LO_MASK = (1 << 32) - 1


def _range_rows(first, counts):
    """Rows of consecutive ranges [first, first + count): (sum counts,)."""
    total = int(counts.sum())
    offs = torch.arange(total, device=first.device) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    return torch.repeat_interleave(first, counts) + offs


def _clip_to_tiles(arr, tile, row, ordinal, tiles_x: int):
    """(tile, packet row) visits -> those whose packet bbox meets the
    tile: (array, packet row, walk ordinal, and the bbox inside the tile
    lx, hx, ly, hy), each (pairs,) int64; None when no visit is left."""
    bb = arr[row, COL_BBOX:COL_BBOX + 4].to(torch.int64)
    tyi = torch.div(tile, tiles_x, rounding_mode="floor")
    tx0 = (tile - tyi * tiles_x) * TILE_W
    ty0 = tyi * TILE_H
    lx = torch.maximum(bb[:, 0], tx0)
    hx = torch.minimum(bb[:, 2], tx0 + TILE_W)
    ly = torch.maximum(bb[:, 1], ty0)
    hy = torch.minimum(bb[:, 3], ty0 + TILE_H)
    keep = (hx > lx) & (hy > ly)
    if not bool(keep.any()):
        return None
    return (arr, row[keep], ordinal[keep], lx[keep], hx[keep], ly[keep],
            hy[keep])


def _item_pairs(items, n_items, packets, huge_rows, tiles_x: int,
                span_w: int, span_h: int):
    """The (tile, packet) pairs of a work list (`walk_items`), per packet
    array, as `_clip_to_tiles` gives them."""
    stride = ordinal_stride(packets.shape[0], huge_rows.shape[0], span_w,
                            span_h)
    huge_seg = 1 + span_w * span_h
    it = items[:int(n_items[0])].long()
    for arr, sel in ((packets, it[:, 1] != huge_seg),
                     (huge_rows, it[:, 1] == huge_seg)):
        tile, seg, first, counts = it[sel].T
        if int(counts.sum()) == 0:
            continue
        row = _range_rows(first, counts)
        ordinal = torch.repeat_interleave(seg, counts) * stride + row
        pairs = _clip_to_tiles(arr, torch.repeat_interleave(tile, counts),
                               row, ordinal, tiles_x)
        if pairs is not None:
            yield pairs


def _walk_pairs(starts, huge_row_starts, packets, huge_rows, tiles_x: int,
                tiles_y: int, span_w: int, span_h: int):
    """The (tile, packet) pairs of the unsliced walk, range by range from
    `scan_ranges`, each clamped to MAX_ENTRIES_PER_TILE: the plain
    versions' own enumeration, which shares nothing with the kernels'
    work list, so that comparing the two checks `walk_items` too."""
    stride = ordinal_stride(packets.shape[0], huge_rows.shape[0], span_w,
                            span_h)
    seg_start, seg_count = scan_ranges(starts, huge_row_starts, tiles_x,
                                       tiles_y, span_w, span_h)
    seg_count = seg_count.clamp_max(MAX_ENTRIES_PER_TILE)
    tile_ids = torch.arange(tiles_x * tiles_y, device=packets.device)
    huge_seg = seg_start.shape[0] - 1
    for s in range(seg_start.shape[0]):
        counts = seg_count[s]
        if int(counts.sum()) == 0:
            continue
        row = _range_rows(seg_start[s], counts)
        pairs = _clip_to_tiles(huge_rows if s == huge_seg else packets,
                               torch.repeat_interleave(tile_ids, counts),
                               row, s * stride + row, tiles_x)
        if pairs is not None:
            yield pairs


def walk_candidates(starts, huge_row_starts, packets, huge_rows,
                    tiles_x: int, tiles_y: int, span_w: int,
                    span_h: int) -> int:
    """(packet, pixel) tests the walk needs: the pixels of each packet's
    bbox inside each tile that visits it, summed over the walk."""
    return sum(int(((hx - lx) * (hy - ly)).sum())
               for _a, _r, _o, lx, hx, ly, hy in _walk_pairs(
                   starts, huge_row_starts, packets, huge_rows, tiles_x,
                   tiles_y, span_w, span_h))


def _merge_pairs(keys, pairs, pw: int) -> None:
    """Evaluates (tile, packet) pairs on the pixels of each packet's bbox
    inside the tile and merges the hits into `keys` ((ph * pw,) int64)
    with amax of the 64-bit key (depth bits << 32 | ~walk ordinal)."""
    arr, row, ordinal, lx, hx, ly, hy = pairs
    dev = keys.device
    pk = arr[row, :20]
    w = hx - lx
    area = w * (hy - ly)
    cum = torch.cumsum(area, 0)
    n_cand = int(cum[-1])
    # batch boundaries on whole pairs, ~_PLAIN_BATCH candidates each
    bounds = torch.searchsorted(
        cum, torch.tensor(list(range(_PLAIN_BATCH, n_cand, _PLAIN_BATCH)),
                          dtype=cum.dtype, device=dev),
        right=True).tolist()
    for p0, p1 in zip([0] + bounds, bounds + [row.shape[0]]):
        if p1 <= p0:
            continue
        ar = area[p0:p1]
        n = int(ar.sum())
        pair = torch.repeat_interleave(torch.arange(p0, p1, device=dev), ar)
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
        key = (zbits << 32) | (_LO_MASK - ordinal[pair[cover]])
        pix = yi[cover] * pw + xi[cover]
        keys.scatter_reduce_(0, pix, key, reduce="amax")


def plain_keys(items, n_items, packets, huge_rows, tiles_x: int,
               tiles_y: int, span_w: int, span_h: int) -> torch.Tensor:
    """The merged keys of a work list without the walk: every (tile,
    packet) pair of every item is evaluated on the pixels of the
    packet's bbox inside the tile, and each pixel keeps the maximum of
    the 64-bit key (depth bits << 32 | ~walk ordinal): the nearest hit,
    the first-visited packet winning ties — what the sequential walk with
    its strict GREATER test computes.  Early-z stops change nothing
    (they only skip packets that cannot pass the test).  -> (ph * pw,)
    int64, 0 where nothing covers."""
    pw = tiles_x * TILE_W
    keys = torch.zeros(tiles_y * TILE_H * pw, dtype=torch.int64,
                       device=packets.device)
    for pairs in _item_pairs(items, n_items, packets, huge_rows, tiles_x,
                             span_w, span_h):
        _merge_pairs(keys, pairs, pw)
    return keys


def decode_keys(keys, n_small: int, n_huge: int, span_w: int, span_h: int):
    """Merged keys -> (depth f32, gid int64), flat like `keys`: gid is the
    winning packet row, offset by n_small for huge-list rows; -1 where
    nothing covers."""
    stride = ordinal_stride(n_small, n_huge, span_w, span_h)
    hit = keys > 0
    depth = (keys >> 32).to(torch.int32).view(torch.float32)
    depth = torch.where(hit, depth, torch.zeros_like(depth))
    ordinal = _LO_MASK - (keys & _LO_MASK)
    seg = torch.div(ordinal, stride, rounding_mode="floor")
    row = ordinal - seg * stride
    gid = torch.where(seg == 1 + span_w * span_h, row + n_small, row)
    gid = torch.where(hit, gid, torch.full_like(gid, -1))
    return depth, gid


def plain_winners(starts, huge_row_starts, packets, huge_rows,
                  tiles_x: int, tiles_y: int, span_w: int, span_h: int):
    """The walk's result in plain PyTorch: the keys of the unsliced walk
    (`_walk_pairs`, not the kernels' work list), merged as in
    `plain_keys` -> (depth (ph, pw) f32, gid (ph, pw) int64), see
    decode_keys."""
    ph, pw = tiles_y * TILE_H, tiles_x * TILE_W
    keys = torch.zeros(ph * pw, dtype=torch.int64, device=packets.device)
    for pairs in _walk_pairs(starts, huge_row_starts, packets, huge_rows,
                             tiles_x, tiles_y, span_w, span_h):
        _merge_pairs(keys, pairs, pw)
    depth, gid = decode_keys(keys, packets.shape[0], huge_rows.shape[0],
                             span_w, span_h)
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


def walk_launch_args(name: str, starts, huge_row_starts, packets,
                     huge_rows, tiles_x: int, tiles_y: int, span_w: int,
                     span_h: int):
    """Checks the bin arrays for a CUDA launch of B1 or B2 and builds the
    walk's inputs: the work list, its length and the scratch of merged
    keys ((ph * pw + 1,) int64: the keys, then the work counter; the
    entry point clears it).  -> (items, n_items, scratch, stride)."""
    dev = packets.device
    ntiles = tiles_x * tiles_y
    K.check(starts, "starts", torch.int32, dev, 1)
    K.check(huge_row_starts, "huge_row_starts", torch.int32, dev, 1)
    K.check(packets, "packets", torch.float32, dev, 2)
    K.check(huge_rows, "huge_rows", torch.float32, dev, 2)
    if starts.shape[0] != 2 * ntiles + 1 or \
            huge_row_starts.shape[0] != tiles_y + 1 or \
            packets.shape[1] != PACKET_F32 or \
            huge_rows.shape[1] != PACKET_F32:
        raise ValueError(f"{name}: inconsistent bin arrays")
    if packets.data_ptr() % 16 or huge_rows.data_ptr() % 16:
        raise ValueError(f"{name}: packet rows must be 16-byte aligned")
    n_small, n_huge = packets.shape[0], huge_rows.shape[0]
    stride = ordinal_stride(n_small, n_huge, span_w, span_h)
    items, n_items = walk_items(starts, huge_row_starts, tiles_x, tiles_y,
                                span_w, span_h, n_small, n_huge)
    ph, pw = tiles_y * TILE_H, tiles_x * TILE_W
    scratch = torch.empty(ph * pw + 1, dtype=torch.int64, device=dev)
    return items, n_items, scratch, stride


def raster_tiles(starts, huge_row_starts, packets, huge_rows,
                 tiles_x: int, tiles_y: int, span_w: int, span_h: int):
    """Kernel B1 (replaces granite_tpu/ops/raster_binned.py
    _raster_tile_kernel): -> depth (ph, pw) f32, tri (ph, pw) int32,
    cleared past the triangles' bboxes (which lie in the viewport)."""
    dev = packets.device
    if dev.type == "cpu":
        return raster_tiles_plain(starts, huge_row_starts, packets,
                                  huge_rows, tiles_x, tiles_y, span_w,
                                  span_h)
    if dev.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {dev}")
    items, n_items, scratch, stride = walk_launch_args(
        "raster_tiles", starts, huge_row_starts, packets, huge_rows,
        tiles_x, tiles_y, span_w, span_h)
    ph, pw = tiles_y * TILE_H, tiles_x * TILE_W
    depth = torch.empty((ph, pw), dtype=torch.float32, device=dev)
    tri = torch.empty((ph, pw), dtype=torch.int32, device=dev)
    K.launch("B1", "granite_raster_binned", K.ptr(items), K.ptr(n_items),
             K.ptr(packets), K.ptr(huge_rows), K.ptr(scratch), K.ptr(depth),
             K.ptr(tri), tiles_x, tiles_y, span_w * span_h, stride)
    return depth, tri


def binned_raster_args(setup: TriangleSetup, width: int, height: int,
                       huge_cap: int = 1024, max_visible: int | None = None,
                       span_w: int = SPAN_W, span_h: int = SPAN_H):
    """bin_triangles -> (raster_tiles' arguments, stats): the binner's
    overflow counters plus max_bin_entries and clamped_entries."""
    tx = -(-width // TILE_W)
    ty = -(-height // TILE_H)
    packets, starts, huge_rows, huge_row_starts, stats = bin_triangles(
        setup, width, height, huge_cap, max_visible=max_visible,
        span_w=span_w, span_h=span_h)
    stats["max_bin_entries"] = (starts[1:] - starts[:-1]).max()
    stats["clamped_entries"] = clamped_entries(
        starts, huge_row_starts, tx, ty, span_w, span_h)
    return (starts, huge_row_starts, packets, huge_rows, tx, ty, span_w,
            span_h), stats


def rasterize_binned(setup: TriangleSetup, width: int, height: int,
                     huge_cap: int = 1024, max_visible: int | None = None,
                     span_w: int = SPAN_W, span_h: int = SPAN_H,
                     with_stats: bool = False):
    """Full binned rasterization -> (depth (H, W), tri (H, W))
    [, stats (binned_raster_args')]."""
    args, stats = binned_raster_args(setup, width, height, huge_cap,
                                     max_visible, span_w, span_h)
    depth, tri = raster_tiles(*args)
    depth, tri = depth[:height, :width], tri[:height, :width]
    return (depth, tri, stats) if with_stats else (depth, tri)
