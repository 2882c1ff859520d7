"""Multi-device binned raster: each rank owns a row band's triangles (port
of granite_tpu/parallel/sharded_raster.py).

The JAX module runs one `shard_map` body a device; here every rank of a
TileMesh runs the same body on its own band:

  1. band cull: a triangle joins the band's stream only when its bbox
     meets the band's rows (`band_cull_setup`, bit-equal to JAX's);
  2. band compaction: the survivors compact into `band_capacity` slots
     (the binner's `max_visible`), so binning, sorting and kernel B1 run
     on ~T/n triangles instead of T.  Overflow is counted, never silent:
     the binner's counters come back for every band;
  3. the band rasterizes in band-local rows through
     `ops/raster_binned.raster_tiles` (B1 once on a CUDA tensor, its
     plain version on a CPU one), and the bands are concatenated over
     the ranks by `all_gather`, triangle ids staying global.

The shift of the anchors by -y0 is exact while `ey - y0` keeps the
operand's precision; a vertex far above its band can lose low bits
there, in this port as in the reference.
"""

from __future__ import annotations

import torch

from ..ops.raster import TriangleSetup
from ..ops.raster_binned import SPAN_H, SPAN_W, binned_raster_args, \
    raster_tiles

# The binner's counters gathered for every band, in this order.
BAND_STATS = ("visible_overflow", "huge_overflow", "clamped_entries",
              "exact_entries", "window_entries", "max_bin_entries")


def band_cull_setup(setup: TriangleSetup, y0: int, band_h: int
                    ) -> TriangleSetup:
    """Restrict and translate a TriangleSetup to rows [y0, y0 + band_h):
    the anchors' y (edge lane 4, offset lane 1) minus y0, the bbox's rows
    clipped to the band, `valid` and-ed with the band test."""
    y0f = torch.tensor(float(y0), dtype=torch.float32,
                       device=setup.edge.device)
    inter = setup.valid & (setup.bbox[:, 1] < y0 + band_h) \
        & (setup.bbox[:, 3] > y0)
    edge = setup.edge.clone()
    edge[:, :, 4] -= y0f
    offset = setup.offset.clone()
    offset[:, 1] -= y0f
    bbox = torch.stack([
        setup.bbox[:, 0],
        (setup.bbox[:, 1] - y0).clamp(0, band_h),
        setup.bbox[:, 2],
        (setup.bbox[:, 3] - y0).clamp(0, band_h),
    ], dim=1).to(setup.bbox.dtype)
    return setup._replace(edge=edge, offset=offset, valid=inter, bbox=bbox)


def default_band_capacity(n_triangles: int, n_bands: int) -> int:
    """~2x the uniform share absorbs skew (the JAX default)."""
    return min(n_triangles, max(2 * n_triangles // n_bands, 1024))


def band_raster_args(setup: TriangleSetup, width: int, y0: int,
                     band_h: int, band_capacity: int, huge_cap: int = 1024,
                     span_w: int = SPAN_W, span_h: int = SPAN_H):
    """The band of rows [y0, y0 + band_h) culled and binned at
    band_capacity -> (kernel B1's raster_tiles arguments, the binner's
    stats, the band's setup)."""
    local = band_cull_setup(setup, y0, band_h)
    args, stats = binned_raster_args(local, width, band_h, huge_cap,
                                     band_capacity, span_w, span_h)
    return args, stats, local


def rasterize_binned_sharded(setup: TriangleSetup, width: int, height: int,
                             mesh, band_capacity: int | None = None,
                             huge_cap: int = 1024, span_w: int = SPAN_W,
                             span_h: int = SPAN_H):
    """rasterize_binned with each rank of `mesh` owning height / n rows.

    -> (depth (H, W), tri (H, W), band_counts (n,) int32, stats) on every
    rank.  band_counts is each band's post-cull triangle count (the
    per-rank work a test holds against the replicated raster); stats maps
    each of BAND_STATS to its (n,) int64 value per band."""
    n = mesh.size
    assert height % n == 0, (height, n)
    band_h = height // n
    if band_capacity is None:
        band_capacity = default_band_capacity(setup.adj.shape[0], n)
    args, stats, local = band_raster_args(setup, width, mesh.rank * band_h,
                                          band_h, band_capacity, huge_cap,
                                          span_w, span_h)
    depth, tri = raster_tiles(*args)
    # depth and the ids' bits side by side (B1's padding cropped): one
    # all_gather of the rows
    both = mesh.all_gather_rows(torch.cat(
        [depth[:band_h, :width],
         tri[:band_h, :width].contiguous().view(torch.float32)], dim=1))
    mine = torch.stack([local.valid.sum()] + [
        stats[k].to(torch.int64).reshape(()) for k in BAND_STATS])
    per_band = mesh.all_gather_rows(mine[None])
    return (both[:, :width].contiguous(),
            both[:, width:].contiguous().view(torch.int32),
            per_band[:, 0].to(torch.int32),
            {k: per_band[:, i + 1] for i, k in enumerate(BAND_STATS)})
