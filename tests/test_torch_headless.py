"""The port's headless runner and viewer entry on the CPU: the stat JSON
keeps the JAX engine's schema (granite_tpu.core.stats); the runner makes
the JAX runner's calls (frame and elapsed times, warm-up, --chain,
--capture-probe); --png-reference-path, --video-path and --chain do what
the JAX runner's do; the viewer refuses the scene arguments it cannot
honour instead of rendering the procedural scene in their place.

The probe capture is held against the JAX viewer's .npy within 2/255 at
any texel and 0.25/255 on average (8-bit renders of the two packages'
faces, 48 dB apart at most on the golden configs)."""

import json
import types

import numpy as np
import pytest
import torch

from granite_tpu.app.headless import run_headless as jax_run_headless
from granite_tpu.core.stats import StatSink as JaxStatSink
from granite_tpu_torch.app import video_sink
from granite_tpu_torch.app.headless import run_headless
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.core.stats import StatSink, TimestampIntervalStats
from granite_tpu_torch.utils.image_io import load_image, save_png


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process: the Tier-1 run puts several
    xdist workers on the machine's cores, and torch's default pool (a
    thread a core in every worker) then oversubscribes them, and a CPU
    render's thousands of small ops slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stat_sink_matches_jax():
    got, want = StatSink("cpu"), JaxStatSink("cpu", "granite_tpu_torch-0.1")
    for sink in (got, want):
        for s in (0.01, 0.03, 0.02):
            sink.add_frame(s)
        sink.counters["compileTimeMs"] = 12.5
        sink.intervals.accumulate("pass:gbuffer", 2e-3)
        sink.intervals.accumulate("pass:gbuffer", 4e-3)
    assert got.to_dict() == want.to_dict()
    assert got.to_dict()["version"] == "granite_tpu_torch-0.1"
    t = TimestampIntervalStats()
    t.accumulate("a", 1.0)
    t.reset()
    assert t.averages_us() == {}


def _app():
    app = SceneViewerApplication(types.SimpleNamespace(
        config=None, bench_scene=False), device="cpu")
    app.config.shadow_map_resolution = 32
    app.config.clustered_lights_shadows = False
    return app


@pytest.mark.parametrize("profile", [False, True])
def test_stat_json_has_the_jax_schema(tmp_path, profile):
    stat = tmp_path / "stat.json"
    args = types.SimpleNamespace(
        frames=2, width=32, height=18, time_step=None, warmup_frames=1,
        png_path=str(tmp_path / "out.png"), stat=str(stat),
        profile=str(tmp_path / "profile.txt") if profile else None)
    assert run_headless(_app(), args) == 0
    doc = json.loads(stat.read_text())
    assert doc.keys() == JaxStatSink("cpu").to_dict().keys()
    assert doc["gpu"] == "cpu" and doc["version"] == "granite_tpu_torch-0.1"
    assert doc["frames"] == 2 and doc["averageFrameTimeUs"] > 0
    assert set(doc["performanceCounters"]) == {"compileTimeMs",
                                               "wallTimePerFrameUs"}
    assert doc["performanceCounters"]["compileTimeMs"] > 0
    if profile:
        assert {"pass:shadow-main", "pass:forward", "pass:tonemap"} \
            <= set(doc["passTimesUs"])
        assert all(v > 0 for v in doc["passTimesUs"].values())
    else:
        assert doc["passTimesUs"] == {}


@pytest.mark.parametrize("extra", [{"scene": "scene.gltf"},
                                   {"camera_index": 0},
                                   {"scene": "scene.gltf", "camera_index": 2}])
def test_scene_arguments_raise(extra):
    """A scene file that is not there, and a camera index past the
    scene's cameras (the procedural test scene has none), raise instead
    of rendering the procedural scene or framing its bounds."""
    args = types.SimpleNamespace(config=None, bench_scene=False, **extra)
    with pytest.raises(FileNotFoundError if "scene" in extra
                       else ValueError):
        SceneViewerApplication(args, device="cpu")


def test_default_scene_arguments_render():
    """scene=None and camera_index=-1 (the JAX CLI's defaults) take the
    procedural test scene."""
    app = SceneViewerApplication(types.SimpleNamespace(
        config=None, bench_scene=False, scene=None, camera_index=-1),
        device="cpu")
    assert len(app.info.meshes) > 0


class _Recorder:
    """An app that records the runner's calls, with the surface both
    runners use: its frame-ring hub (track, next_frame_context; the JAX
    runner's `app.device`, the port's `app.hub`) records its calls too,
    and so does teardown."""

    def __init__(self):
        self.calls = []
        frame = types.SimpleNamespace(
            track=lambda out: self.calls.append(("track",)))
        self.device = types.SimpleNamespace(
            type="cpu",
            backend=types.SimpleNamespace(gpu_name=lambda: "cpu"),
            frame=lambda: frame,
            next_frame_context=lambda: self.calls.append(
                ("next_frame_context",)),
            stats=types.SimpleNamespace(averages_us=lambda: {}))
        self.hub = self.device

    def _image(self):
        return torch.zeros((4, 6, 4), dtype=torch.uint8)

    def swapchain_updated(self, width, height):
        self.calls.append(("swapchain", width, height))

    def render_frame(self, frame_time, elapsed_time):
        self.calls.append(("frame", frame_time, elapsed_time))
        return self._image()

    def render_frames_chained(self, frame_time, t0, n):
        self.calls.append(("chain", frame_time, t0, n))
        return self._image()

    def capture_environment_probe(self, path, face_size, equirect_height):
        self.calls.append(("probe", path, face_size, equirect_height))

    def post_frame(self):
        self.calls.append(("post_frame",))

    def teardown(self):
        self.calls.append(("teardown",))


def _args(**kw):
    base = dict(frames=3, width=6, height=4, time_step=None,
                warmup_frames=2, png_path=None, png_reference_path=None,
                stat=None, video_path=None, chain=False, capture_probe=None,
                profile=None)
    return types.SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("kw", [
    {"time_step": 0.02}, {"time_step": 1 / 60, "frames": 5},
    {"time_step": 0.02, "chain": True},
    {"time_step": 0.05, "capture_probe": "probe.png", "warmup_frames": 0}])
def test_runner_calls_match_jax(kw):
    """The port's runner renders with the JAX runner's (frame time,
    elapsed time) sequence: warm-up frames at elapsed 0, timed frame i at
    (i + 1) x step under --time-step, each timed frame followed by
    the frame ring's track and next_frame_context, then post_frame
    (texture streaming's latch), and the warm-up frames and the chain by
    none; --chain and --capture-probe call the app as the JAX runner
    does; teardown comes last."""
    got, want = _Recorder(), _Recorder()
    assert run_headless(got, _args(**kw)) == 0
    assert jax_run_headless(want, _args(**kw)) == 0
    assert got.calls == want.calls
    assert len(got.calls) > 1
    assert got.calls[-1] == ("teardown",)


def test_png_reference_writes_psnr_and_rejects_other_sizes(tmp_path):
    # A fixed time step: under the wall clock the two runs render their
    # frame at different elapsed times, and the frames then differ.
    out, stat = tmp_path / "out.png", tmp_path / "stat.json"
    assert run_headless(_app(), _args(
        frames=1, width=32, height=18, warmup_frames=0, time_step=0.02,
        png_path=str(out))) == 0
    assert run_headless(_app(), _args(
        frames=1, width=32, height=18, warmup_frames=0, time_step=0.02,
        stat=str(stat), png_reference_path=str(out))) == 0
    counters = json.loads(stat.read_text())["performanceCounters"]
    assert {"psnrR", "psnrG", "psnrB", "psnrLuma", "rmsePercent"} \
        <= set(counters)
    assert counters["psnrLuma"] == 99.0 and counters["rmsePercent"] == 0.0
    other = tmp_path / "other.png"
    save_png(str(other), np.zeros((9, 16, 4), np.uint8))
    assert run_headless(_app(), _args(
        frames=1, width=32, height=18, warmup_frames=0,
        png_reference_path=str(other))) == 1


def test_video_path_writes_a_png_sequence(tmp_path, monkeypatch):
    """With no ffmpeg on the PATH every timed frame becomes a PNG."""
    monkeypatch.setattr(video_sink.shutil, "which", lambda name: None)
    assert run_headless(_app(), _args(
        frames=3, width=32, height=18, warmup_frames=0,
        video_path=str(tmp_path / "clip.mp4"))) == 0
    pngs = sorted((tmp_path / "clip_frames").iterdir())
    assert [p.name for p in pngs] == [f"frame_{i:05d}.png" for i in range(3)]
    assert load_image(str(pngs[-1])).shape == (18, 32, 4)


def test_chain_renders_and_refuses_video(tmp_path):
    out = tmp_path / "out.png"
    assert run_headless(_app(), _args(
        frames=2, width=32, height=18, chain=True, png_path=str(out))) == 0
    assert load_image(str(out)).shape == (18, 32, 4)
    assert run_headless(_Recorder(), _args(
        chain=True, video_path=str(tmp_path / "clip.mp4"))) == 2


def test_capture_probe_matches_jax(tmp_path):
    """capture_environment_probe at face_size 16 on the test scene: the
    equirect .npy against the JAX viewer's."""
    from granite_tpu.app.scene_viewer import (
        SceneViewerApplication as JaxViewer,
    )
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"shadowMapResolution": 32,
                               "clusteredLightsShadows": False}))
    port = SceneViewerApplication(types.SimpleNamespace(
        config=str(cfg), bench_scene=False), device="cpu")
    jax_app = JaxViewer(types.SimpleNamespace(
        config=str(cfg), bench_scene=False, scene=None, camera_index=-1,
        quirks=None))
    for app, name in ((port, "port.png"), (jax_app, "jax.png")):
        app.swapchain_updated(32, 18)
        app.capture_environment_probe(str(tmp_path / name), face_size=16,
                                      equirect_height=8)
    got = np.load(tmp_path / "port.png.npy")
    want = np.load(tmp_path / "jax.png.npy")
    assert got.shape == want.shape == (8, 16, 3)
    err = np.abs(got - want)
    assert float(err.max()) <= 2 / 255 and float(err.mean()) <= 0.25 / 255
    assert load_image(str(tmp_path / "port.png")).shape == (8, 16, 4)
    assert port.width == 32 and port.height == 18
