"""The port's headless runner and viewer entry on the CPU: the stat JSON
keeps the JAX engine's schema (granite_tpu.core.stats), and the viewer
refuses the scene arguments it cannot honour instead of rendering the
procedural scene in their place."""

import json
import types

import pytest
import torch

from granite_tpu.core.stats import StatSink as JaxStatSink
from granite_tpu_torch.app.headless import run_headless
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.core.stats import StatSink, TimestampIntervalStats


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
    args = types.SimpleNamespace(config=None, bench_scene=False, **extra)
    with pytest.raises(NotImplementedError):
        SceneViewerApplication(args, device="cpu")


def test_default_scene_arguments_render():
    """scene=None and camera_index=-1 (the JAX CLI's defaults) take the
    procedural test scene."""
    app = SceneViewerApplication(types.SimpleNamespace(
        config=None, bench_scene=False, scene=None, camera_index=-1),
        device="cpu")
    assert len(app.info.meshes) > 0
