"""The viewer's frame services in the port: post_frame's config.json hot
reload and GRANITE_WATCH_KERNELS reload, the GRANITE_DEBUG_GRAPH route
(graph/debug.execute_debug: breadcrumbs, the NaN/Inf scan, per-pass
times) and the --quirks flag.

Tolerances: none.  The debug route's frame is bit-equal to the graph's
(the same passes on the same inputs, one at a time), and the toy graph's
breadcrumbs name the passes the JAX package's do.  mtimes are set
explicitly: no sleeps."""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from granite_tpu.graph import (
    AttachmentInfo as JaxAttachmentInfo, RenderGraph as JaxRenderGraph,
    SizeClass as JaxSizeClass,
)
from granite_tpu.graph.debug import execute_debug as jax_execute_debug
from granite_tpu_torch.app.headless import headless_main, run_headless
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.graph.debug import execute_debug
from granite_tpu_torch.graph.render_graph import (
    AttachmentInfo, RenderGraph, SizeClass,
)
from granite_tpu_torch.kernels import build as K
from granite_tpu_torch.ops import hdr as hdr_module

# the golden deferred config at its cheapest
CONFIG = {"renderer": "deferred", "hdrBloom": True, "shadowMapResolution": 64,
          "clusteredLightsShadowsResolution": 64}
STEP = 1.0 / 60.0


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


def _viewer(config_path: str) -> SceneViewerApplication:
    return SceneViewerApplication(types.SimpleNamespace(
        config=config_path, scene=None, camera_index=-1, bench_scene=False),
        device="cpu")


def _touch(path: str) -> None:
    mtime = os.stat(path).st_mtime + 10.0
    os.utime(path, (mtime, mtime))


def test_config_edit_rebakes_on_next_post_frame(tmp_path, monkeypatch):
    """A relative --config path, edited: the next post_frame reads it
    again and re-bakes the graph; deleting it keeps the knobs."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.json").write_text(
        json.dumps({**CONFIG, "hdrBloom": False}))
    app = _viewer("config.json")
    app.swapchain_updated(64, 36)
    app.post_frame()
    assert not app.config.hdr_bloom
    assert "bloom-threshold" not in app.graph._order
    (tmp_path / "config.json").write_text(json.dumps(CONFIG))
    _touch("config.json")
    app.post_frame()
    assert app.config.hdr_bloom
    assert "bloom-threshold" in app.graph._order
    order = list(app.graph._order)
    os.unlink("config.json")
    app.post_frame()
    assert app.config.hdr_bloom and app.graph._order == order
    assert app.render_frame(STEP, 0.0).shape == (36, 64, 4)


def test_kernel_watch_reloads_and_rebakes(tmp_path, monkeypatch):
    """GRANITE_WATCH_KERNELS: the op and renderer modules and the CUDA
    sources are watched; a changed module is reloaded, a changed source
    drops the loaded kernel library (the next launch rebuilds it under
    its new hash), and either re-bakes the graph."""
    monkeypatch.setenv("GRANITE_WATCH_KERNELS", "1")
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CONFIG))
    app = _viewer(str(cfg))
    app.swapchain_updated(64, 36)
    watched = {os.path.relpath(p, K.PACKAGE_DIR) for p, _ in
               app._kernel_watch}
    assert {"ops/hdr.py", "renderer/scene_renderer.py",
            "csrc/tile_sampler.cu", "csrc/raster_walk.cuh"} <= watched
    app.post_frame()
    history = app._history
    monkeypatch.setattr(K, "_library", object())
    for ent in app._kernel_watch:
        # recorded as older than the file: the next poll sees a change
        if ent[0].endswith(("ops/hdr.py", "csrc/shade_fused.cu")):
            ent[1] -= 10.0
    before = hdr_module.tonemap
    app.post_frame()
    assert K._library is None
    assert hdr_module.tonemap is not before        # re-executed
    assert app._history is not history
    assert app.render_frame(STEP, 0.0).shape == (36, 64, 4)


def test_debug_graph_gives_the_same_frame(tmp_path, monkeypatch):
    """GRANITE_DEBUG_GRAPH: the frames equal the graph's bit for bit, the
    breadcrumbs name every pass in order with its time and no NaN, and
    the headless stat JSON's passTimesUs stays empty without --profile."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CONFIG))
    plain = _viewer(str(cfg))
    plain.swapchain_updated(128, 72)
    want = [plain.render_frame(STEP, i * STEP) for i in range(2)]
    monkeypatch.setenv("GRANITE_DEBUG_GRAPH", "1")
    app = _viewer(str(cfg))
    app.swapchain_updated(128, 72)
    got = [app.render_frame(STEP, i * STEP) for i in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    crumbs = app.last_breadcrumbs
    assert crumbs.completed == app.graph._order
    assert len(crumbs.completed) >= 10
    assert crumbs.failed is None and crumbs.nan_passes == []
    assert set(crumbs.pass_times_ms) == set(crumbs.completed)
    assert set(app.hub.stats.averages_us()) == \
        {f"pass:{p}" for p in crumbs.completed}
    stat = tmp_path / "stat.json"
    assert run_headless(app, types.SimpleNamespace(
        frames=1, width=64, height=36, time_step=STEP, warmup_frames=0,
        png_path=None, png_reference_path=None, stat=str(stat),
        video_path=None, chain=False, capture_probe=None,
        profile=None)) == 0
    # host-clock times stay out of passTimesUs (device times, --profile)
    assert json.loads(stat.read_text())["passTimesUs"] == {}


def _toy(kind: str, fail_in=None, nan_in=None):
    """tests/test_debug_graph.py's four-pass chain, in either package."""
    jax = kind == "jax"
    g = JaxRenderGraph() if jax else RenderGraph()
    g.set_backbuffer_dimensions(4, 4)
    info = (JaxAttachmentInfo(JaxSizeClass.ABSOLUTE, 4, 4, channels=1)
            if jax else AttachmentInfo(SizeClass.ABSOLUTE, 4, 4, channels=1))
    ones = jnp.ones if jax else torch.ones

    def make(i):
        def ex(ctx):
            x = (ctx.input(f"r{i - 1}") + 1.0) if i else ones((4, 4))
            if fail_in == i:
                raise RuntimeError("simulated device fault")
            if nan_in == i:
                x = x / 0.0 * 0.0
            return {f"r{i}": x}
        return ex
    for i in range(4):
        p = g.add_pass(f"p{i}").add_color_output(f"r{i}", info)
        if i:
            p.add_texture_input(f"r{i - 1}")
        p.set_execute(make(i))
    g.set_backbuffer_source("r3")
    g.bake()
    return g


@pytest.mark.parametrize("case", ["ok", "fault", "nan"])
def test_execute_debug_breadcrumbs_match_jax(case):
    kw = {"fault": {"fail_in": 2}, "nan": {"nan_in": 1}}.get(case, {})
    jg, tg = _toy("jax", **kw), _toy("port", **kw)
    if case == "fault":
        with pytest.raises(RuntimeError, match="simulated device fault"):
            execute_debug(tg, {}, tg.initial_history("cpu"))
        return
    jout, _, jcrumbs = jax_execute_debug(jg, {}, jg.initial_history())
    out, _, crumbs = execute_debug(tg, {}, tg.initial_history("cpu"))
    assert crumbs.completed == jcrumbs.completed == ["p0", "p1", "p2", "p3"]
    assert crumbs.nan_passes == jcrumbs.nan_passes
    assert np.array_equal(out.numpy(), np.asarray(jout), equal_nan=True)
    if case == "nan":
        assert crumbs.nan_passes[0] == "p1"
        assert "[NaN/Inf!]" in crumbs.report()


def test_quirks_are_accepted(tmp_path, caplog):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CONFIG))
    quirks = tmp_path / "quirks.json"
    quirks.write_text(json.dumps({"forceNoSubgroups": True,
                                  "useTransientColor": False}))
    out = tmp_path / "out.png"
    assert headless_main(SceneViewerApplication, [
        "--config", str(cfg), "--quirks", str(quirks), "--device", "cpu",
        "--frames", "1", "--warmup-frames", "0", "--width", "32",
        "--height", "18", "--png-path", str(out)]) == 0
    assert out.exists()
    logged = " ".join(r.getMessage() for r in caplog.records)
    assert "forceNoSubgroups" in logged and "useTransientColor" in logged
