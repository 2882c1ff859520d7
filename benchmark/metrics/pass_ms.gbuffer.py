"""Device ms a frame of the render graph's pass:gbuffer range (the kernels
launched inside it), over the traced frames; nothing where the graph has
no such pass."""

from gbench.trace import range_ms


def read(run):
    return range_ms(run["trace"], "pass:gbuffer")
