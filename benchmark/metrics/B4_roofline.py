"""Kernel B4's share of its roofline over the traced frames: its bound at
the cell's shapes (gbench/roofline.b4_bound, the published peaks) over
the device time of a call; nothing where no B4 was traced."""

from gbench.trace import kernel_calls


def read(run):
    calls = kernel_calls(run["trace"], "shade_fused_kernel")
    if not calls:
        return None
    return 100.0 * run["b4_bound_ms"] * len(calls) / sum(calls)
