"""Host ms of the viewer's render_frame call (app/headless +
app/scene_viewer: pose, culling, light bins, params, the graph's
enqueue), the mean over the window's frames: the harness's own span."""


def read(run):
    v = run["render_call_ms"]
    return sum(v) / len(v)
