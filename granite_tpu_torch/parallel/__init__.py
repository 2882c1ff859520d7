"""Multi-device framebuffer over torch.distributed (port of
granite_tpu/parallel): row bands of the frame over the ranks of a
process group, and the binned raster with each rank owning its band's
triangles.  `python -m granite_tpu_torch.parallel` runs its legs."""

from .framebuffer_sharding import make_tile_mesh, shard_frame_step
from .sharded_raster import band_cull_setup, rasterize_binned_sharded
