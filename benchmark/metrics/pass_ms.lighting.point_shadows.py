"""Device ms a frame of the lighting pass's point-light shadow terms (the
top-K atlas lookups of the clustered lights), the program's range
pass:lighting/light.point_shadows (the kernels launched inside it), over
the traced frames; nothing where the program opens no such range."""

from gbench.trace import range_ms


def read(run):
    return range_ms(run["trace"], "pass:lighting/light.point_shadows")
