"""Least-time arithmetic of the kernels' work, frozen from chip_smoke.py
(nbytes, bound, walk_bound and B4's byte count) at commit 757dbb804350,
with gref's frozen copies of the port's binning in place of the port's
own (so the count reads the same work whatever implements the kernel).
The yardsticks are the published peaks of one H100 SXM at 700 W."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of one (packet, pixel) test of B1/B2, as the plain
# version writes it: 3 edges x (2 sub, 2 mul, 2 add) + the z plane's 6.
EDGE_TEST_OPS = 24
# Bytes of a packet row the walk needs (the four 32-byte sectors of lanes
# 0-23 and 120-127 that it stages).
WALK_ROW_BYTES = 128
# Lanes the resolve reads of a winner: B2 the payload lanes 21-75.
B2_WINNER_LANES = 55
# B2's payload a triangle: the folded adjugate (9) and the resolve's
# attributes and material (46).
B2_PAYLOAD_LANES = 55
# B4's tiling (ops/shade_fused.py at the same commit): planes padded to
# TILE_H x TILE_W tiles, P_FIXED planes plus 2 per shadowed light slot,
# one mask word per CLUSTER_TILE^2 pixels.
TILE_H, TILE_W, CLUSTER_TILE, P_FIXED = 32, 128, 64, 26


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int = 0) -> dict:
    """The least time for the work: bytes at the memory rate or FP32
    operations at the peak rate, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, ops=n_ops)


def walk_bound(args, out_bytes: int, winner_lanes: int) -> dict:
    """B1/B2's bound on these bin arrays.  Bytes: the bin offsets; each
    binned packet row once at WALK_ROW_BYTES; `winner_lanes` 4-byte lanes
    of each distinct winning triangle; the outputs.  Ops: EDGE_TEST_OPS
    for each (packet, pixel of its bbox in a visiting tile) pair."""
    import torch
    from gref.ops import raster_binned as RB
    st, hs, pk, hr, tx, ty, span_w, span_h = args[:8]
    rows = int(st[-1]) + int(hs[-1])
    _depth, gid = RB.plain_winners(*args[:8])
    ids = torch.cat([pk[:, RB.COL_TRI], hr[:, RB.COL_TRI]]) \
        .contiguous().view(torch.int32)
    winners = int(ids[gid[gid >= 0]].unique().numel())
    cand = RB.walk_candidates(*args[:8])
    b = bound(nbytes(st, hs) + rows * WALK_ROW_BYTES
              + winners * winner_lanes * 4 + out_bytes,
              cand * EDGE_TEST_OPS)
    b.update(candidates=cand, binned_rows=rows, winners=winners)
    return b


def b4_bound(width: int, height: int, k_shadow: int, light_rows: int) -> dict:
    """B4's inputs once (planes padded to 32 x 128 tiles, the light table,
    the 64-px tile masks, the uniforms) and its (3, H, W) output."""
    ph = -(-height // TILE_H) * TILE_H
    pw = -(-width // TILE_W) * TILE_W
    planes = (P_FIXED + 2 * k_shadow) * ph * pw * 4
    lights = max(light_rows, 1) * 128 * 4
    masks = -(-ph // CLUSTER_TILE) * (pw // CLUSTER_TILE) * 4
    return bound(planes + lights + masks + 8 * 128 * 4 + 3 * height * width
                 * 4)


def b2_frame_bound(ref, position, rotation, max_visible) -> dict:
    """B2's bound at one pose, on the bin arrays the viewer builds there:
    the frame's frustum-culled objects, compacted to max_visible, huge
    lists at the viewer's cap (1024); gref's frozen binning and count
    over the reference's scene arrays (ref: the configuration's
    reference, its sa, view, width and height)."""
    import numpy as np
    import torch
    from gref.math.frustum import Frustum, frustum_cull
    from gref.ops import raster as R
    from gref.ops import raster_binned as RB
    from gref.ops import raster_fused as RF
    from gref.renderer.raster_dispatch import bin_window
    sa = ref.sa
    _view, vp, _cam = ref.view(position, rotation)
    vp32 = vp.astype(np.float32)
    vis = frustum_cull(Frustum(vp32).planes, sa.obj_lo.astype(np.float32),
                       sa.obj_hi.astype(np.float32))
    W, H = ref.width, ref.height
    clip = sa.clip(vp32.astype(np.float64)).to(torch.float32)
    setup = R.setup_triangles(clip, sa.indices.to(torch.int32), W, H)
    mask = torch.as_tensor(vis, device=clip.device)[sa.tri_object]
    setup = setup._replace(valid=setup.valid & mask)
    payload = torch.zeros((sa.indices.shape[0], B2_PAYLOAD_LANES),
                          device=clip.device)
    span_w, span_h = bin_window(W, H)
    pk, st, hr, hs, _stats = RB.bin_triangles(
        setup, W, H, huge_cap=1024, span_w=span_w, span_h=span_h,
        extra=payload, max_visible=max_visible or None)
    tx, ty = -(-W // RB.TILE_W), -(-H // RB.TILE_H)
    out_bytes = RF.NUM_PLANES * ty * RB.TILE_H * tx * RB.TILE_W * 4
    return walk_bound((st, hs, pk, hr, tx, ty, span_w, span_h), out_bytes,
                      B2_WINNER_LANES)
