"""Kernel B2's share of its roofline over the traced frames: the sum of
each frame's bound (gbench/roofline.b2_frame_bound at the frame's pose,
the published peaks) over the device time of its calls (the walk, then
the fused resolve, paired in launch order); nothing where the traced
frames launch no B2 or another kernel shares its walk."""

from gbench.trace import kernel_calls


def read(run):
    resolve = kernel_calls(run["trace"], "raster_fused_resolve_kernel")
    walk = kernel_calls(run["trace"], "raster_walk_kernel")
    if not resolve or len(walk) != len(resolve) or \
            len(resolve) != len(run["b2_bound_ms"]):
        return None
    return 100.0 * sum(run["b2_bound_ms"]) / (sum(walk) + sum(resolve))
