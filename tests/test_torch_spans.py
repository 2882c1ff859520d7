"""The frame path's spans and counters (granite_tpu_torch/utils/
timeline_trace.py) on the CPU, at 128x72 on the test scene: nothing is
opened or kept when tracing is off; under torch.profiler a forward and
a deferred frame show every span their graph reaches, each stage inside
its pass, the pass ranges under their old names, and only `pass:*` and
`decals` as ranges that annotate the card's timeline (`frame:*` ranges
stay on the host); the recorder's self and total times, frame ids and
per-frame counters.  The readback and upload counts on the card are
chip_smoke.py's spans phase."""

import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.utils import timeline_trace as TT

CONFIGS = {
    "forward": {"renderer": "forward", "hdrBloom": False,
                "shadowMapResolution": 64, "clusteredLightsShadows": False,
                "postAA": "none"},
    "deferred": {"renderer": "deferred", "hdrBloom": True,
                 "shadowMapResolution": 64,
                 "clusteredLightsShadowsResolution": 64},
}
STEP = 1.0 / 60.0
FRAME_STAGES = {"frame:render", "frame:animate", "frame:params",
                "frame:params/cull", "frame:params/sun_view",
                "frame:params/node_mats", "frame:params/lights",
                "frame:graph", "frame:ring_wait"}
RASTER = ("raster.transform", "raster.setup", "raster.bin",
          "raster.resolve", "surface.material")
LIGHT = ("light.sun_shadow", "light.env", "light.shade")
STAGES = {
    "forward": {f"pass:forward/{s}" for s in RASTER + LIGHT},
    "deferred": {f"pass:gbuffer/{s}" for s in RASTER}
    | {f"pass:lighting/{s}" for s in LIGHT + ("light.point_shadows",)},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    out = {}
    for name, cfg in CONFIGS.items():
        path = tmp_path_factory.mktemp(name) / "config.json"
        path.write_text(json.dumps(cfg))
        app = SceneViewerApplication(types.SimpleNamespace(
            config=str(path), scene=None, camera_index=-1,
            bench_scene=False), device="cpu")
        app.swapchain_updated(128, 72)
        out[name] = app
    return out


def frame(app) -> None:
    """One frame of the headless loop, the camera moved a little."""
    app.camera.position = app.camera.position + 0.01
    out = app.render_frame(STEP, (app.hub.frame_counter + 1) * STEP)
    app.hub.frame().track(out)
    app.hub.next_frame_context()
    app.post_frame()


def test_naming_rule():
    assert TT.full_name("pass:forward", ["frame:render", "frame:graph"]) \
        == "pass:forward"
    assert TT.full_name("decals", ["pass:forward"]) == "decals"
    assert TT.full_name("params", [TT.ROOT]) == "frame:params"
    assert TT.full_name("cull", [TT.ROOT, "frame:params"]) \
        == "frame:params/cull"
    assert TT.full_name("raster.bin", [TT.ROOT, "frame:graph",
                                       "pass:gbuffer",
                                       "pass:gbuffer/raster.setup"]) \
        == "pass:gbuffer/raster.bin"
    assert TT.full_name("light.env", ["pass:forward", "decals"]) \
        == "pass:forward/light.env"
    assert TT.full_name("ring_wait") == "frame:ring_wait"


def test_off_opens_and_keeps_nothing(apps, monkeypatch):
    """Off, a span is the shared no-op: no profiler range is opened (the
    graph's pass ranges included) and an idle recorder keeps nothing."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    monkeypatch.setattr(TT, "_host_range", lambda name: opened.append(name))
    app = apps["deferred"]
    idle = TT.FrameRecorder(app.hub)
    assert TT.span("params") is TT._OFF
    frame(app)
    assert opened == []
    assert idle.spans == [] and idle.counters == {}
    assert TT._names == [] and TT._idx == []


@pytest.mark.parametrize("name", ["forward", "deferred"])
def test_profiler_sees_every_span(apps, name, monkeypatch):
    """One frame under torch.profiler: every span of the frame path its
    graph reaches, each pass:<p>/<stage> inside pass:<p> in time, the
    pass ranges named as before, and only pass:* and decals sent as
    record_function ranges (which annotate the card's timeline)."""
    app = apps[name]
    frame(app)
    user, host = [], []
    record_function = torch.profiler.record_function

    def user_range(full):
        user.append(full)
        return record_function(full)

    def host_range(full):
        host.append(full)
        return TT.torch._C._profiler._RecordFunctionFast(full)
    monkeypatch.setattr(torch.profiler, "record_function", user_range)
    monkeypatch.setattr(TT, "_host_range", host_range)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame(app)
    spans = [(ev.name, ev.time_range.start, ev.time_range.end)
             for ev in prof.events()
             if ev.name.startswith(("pass:", "frame:", "decals"))]
    names = {n for n, _a, _b in spans}
    passes = {n for n in names if n.startswith("pass:") and "/" not in n}
    assert passes == {f"pass:{p}" for p in app.graph._order}
    assert FRAME_STAGES | STAGES[name] <= names
    for n, a, b in spans:
        if n.startswith("pass:") and "/" in n:
            outer = n.split("/")[0]
            assert any(m == outer and a0 <= a and b <= b0
                       for m, a0, b0 in spans), n
    assert set(user) | set(host) == names
    assert all(n.startswith("pass:") or n == "decals" for n in user)
    assert all(n.startswith("frame:") for n in host)


def test_recorder_frames(apps):
    """The recorder over two deferred frames: self = total - children,
    animate + params + graph within frame:render and >= 90% of it, one
    frame id for the spans of a frame, counters kept a frame."""
    app = apps["deferred"]
    frame(app)
    with TT.FrameRecorder(app.hub) as rec:
        frame(app)
        frame(app)
    frames = rec.frames()
    assert len(frames) == 2
    assert frames[1]["frame"] == frames[0]["frame"] + 1
    for f in frames:
        tot, own = f["total_ms"], f["self_ms"]
        assert FRAME_STAGES | STAGES["deferred"] <= set(tot)
        parts = tot["frame:animate"] + tot["frame:params"] \
            + tot["frame:graph"]
        assert 0.9 * tot["frame:render"] <= parts <= tot["frame:render"]
        assert own["frame:render"] == pytest.approx(
            tot["frame:render"] - parts, abs=1e-6)
        params_parts = sum(tot[f"frame:params/{s}"] for s in
                           ("cull", "sun_view", "node_mats", "lights"))
        assert own["frame:params"] == pytest.approx(
            tot["frame:params"] - params_parts, abs=1e-6)
        stages = sum(v for k, v in tot.items()
                     if k.startswith("pass:lighting/"))
        assert own["pass:lighting"] == pytest.approx(
            tot["pass:lighting"] - stages, abs=1e-6)
        assert all(v >= 0.0 for v in own.values())
    # every span belongs to the frame of the render_frame call it lies
    # in, or (frame:ring_wait) that it follows
    spans = sorted(rec.spans, key=lambda s: s[3])
    current = None
    for name, _parent, fid, _t0, _t1 in spans:
        if name == TT.ROOT:
            current = fid
        assert fid == current, name


def test_counters_a_frame():
    """Counters are kept per frame id (each frame starts from 0), only
    while a recorder is on; a CPU tensor's read and a copy to the CPU
    count nothing."""
    hub = types.SimpleNamespace(frame_counter=7)
    TT.count("uploads")
    with TT.FrameRecorder(hub) as rec:
        TT.count("uploads", 2)
        TT.count("upload_bytes", 64)
        hub.frame_counter += 1
        TT.count("uploads")
        with TT.readback("site", torch.zeros(3)):
            pass
        TT.upload([1.0, 2.0], device="cpu")
        with pytest.raises(RuntimeError):
            with TT.FrameRecorder(hub):
                pass
    TT.count("uploads")
    assert [f["counters"] for f in rec.frames()] == [
        {"uploads": 2, "upload_bytes": 64}, {"uploads": 1}]
    assert [f["frame"] for f in rec.frames()] == [7, 8]
