"""Device ms a frame of the lighting pass's directional sun term (the
half-res PCF of the sun map), the program's range
pass:lighting/light.sun_shadow (the kernels launched inside it), over the
traced frames; nothing where the program opens no such range."""

from gbench.trace import range_ms


def read(run):
    return range_ms(run["trace"], "pass:lighting/light.sun_shadow")
