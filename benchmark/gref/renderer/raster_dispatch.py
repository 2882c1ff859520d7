# Frozen copy of granite_tpu_torch/renderer/raster_dispatch.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""Raster dispatch: kernel B1 on a camera view, with the bin window and
the overflow report (port of granite_tpu/renderer/raster_dispatch.py).

GRANITE_DEBUG_GRAPH set: a non-zero overflow counter (huge or visible
triangles dropped by the binner) is logged once per distinct count; the
reference never drops geometry (render_queue.cpp:41-58), so any is a
correctness event.  The report reads the counters back to the host.
"""

from __future__ import annotations

import os

import torch

from ..ops.raster import TriangleSetup
from ..ops.raster_binned import MAX_ENTRIES_PER_TILE, SPAN_H, SPAN_W, \
    TILE_H, TILE_W, rasterize_binned
from ..utils.logging import LOGW

_DEBUG = bool(os.environ.get("GRANITE_DEBUG_GRAPH"))
_overflow_logged = set()


def bin_window(width: int, height: int):
    """Bin window: the wide 2x8 one for large tile grids (> 512 tiles,
    2048^2-class targets; 1920x1080 has 510 tiles)."""
    ntiles = (-(-width // TILE_W)) * (-(-height // TILE_H))
    return (2, 8) if ntiles > 512 else (SPAN_W, SPAN_H)


def rasterize_binned_checked(setup, width: int, height: int):
    """B1 (its plain version on CPU tensors) over a view of width x
    height with the wide 2x8 bin window above 512 tiles -> (depth, tri,
    raster stats)."""
    span_w, span_h = bin_window(width, height)
    depth, tri, stats = rasterize_binned(setup, width, height,
                                         span_w=span_w, span_h=span_h,
                                         with_stats=True)
    if _DEBUG:
        _report_overflow(stats["huge_overflow"], stats["visible_overflow"],
                         stats["max_bin_entries"])
    return depth, tri, stats


def valid_chunks(setup, chunk: int = MAX_ENTRIES_PER_TILE):
    """The valid triangles of setup in consecutive chunks of at most
    `chunk` -> [(their indices, their setup)].  Finding them reads their
    count back to the host."""
    ids = torch.nonzero(setup.valid)[:, 0]
    if ids.shape[0] == 0:
        # (the binner takes no empty setup: keep one invalid triangle)
        ids = torch.zeros(1, dtype=torch.long, device=ids.device)
    return [(sel, TriangleSetup(*(f[sel] for f in setup)))
            for sel in ids.split(chunk)]


def rasterize_binned_exact(setup, width: int, height: int,
                           chunk: int = MAX_ENTRIES_PER_TILE):
    """B1 over the valid triangles in valid_chunks, merged on depth (ties
    to the earlier chunk, so to the lower triangle index) -> (depth, tri,
    raster stats summed over the chunks, max_bin_entries their largest).
    A chunk cannot put more than MAX_ENTRIES_PER_TILE entries in a tile's
    list, so the walk drops none: the reference's brute-force raster
    drops none either, while a small view's single tile can gather more
    than the clamp (an 8x8 cube face of the 258,774-triangle bench
    scene).  Every camera view of the classic route (the diffuse bake's
    faces, both occlusion-culling phases) rasterizes through here."""
    depth = tri = None
    stats: dict = {}
    for sel, sub in valid_chunks(setup, chunk):
        d, t, st = rasterize_binned_checked(sub, width, height)
        t = torch.where(t >= 0, sel[t.clamp_min(0).long()].to(torch.int32),
                        t)
        for k, v in st.items():
            stats[k] = v if k not in stats else (
                torch.maximum(stats[k], v) if k == "max_bin_entries"
                else stats[k] + v)
        if depth is None:
            depth, tri = d, t
        else:
            closer = d > depth
            depth = torch.where(closer, d, depth)
            tri = torch.where(closer, t, tri)
    return depth, tri, stats


def _report_overflow(huge_overflow, visible_overflow, max_bin):
    key = (int(huge_overflow), int(visible_overflow))
    if key != (0, 0) and key not in _overflow_logged:
        _overflow_logged.add(key)
        LOGW("raster binning overflow: %d huge triangles dropped, %d "
             "visible triangles dropped (max bin entries %d) — raise "
             "huge_cap/max_visible", int(huge_overflow),
             int(visible_overflow), int(max_bin))
