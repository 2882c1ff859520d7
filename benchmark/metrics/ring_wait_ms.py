"""Host ms a frame waits in hub.next_frame_context() for the frame two
back (core/device's frame ring), the mean over the window: the
harness's own span."""


def read(run):
    v = run["ring_wait_ms"]
    return sum(v) / len(v)
