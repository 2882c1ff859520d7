"""The port's RendererSuite (granite_tpu_torch/renderer/suite.py) and the
viewer's graph bake through it: tests/test_renderer_suite.py's three
cases on the port; every role bound to the executor the JAX viewer's
suite binds; re-setting every role to its default renders the same
128x72 frame bit for bit; an overridden lighting role (set before the
bake) changes the frame; forwardDepthPrepass reaches the suite's
config."""

import json
import tempfile
import types

import pytest
import torch

from granite_tpu.app.scene_viewer import SceneViewerApplication as JaxViewer
from granite_tpu.renderer.suite import Type as JaxType
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.renderer.suite import Config, RendererSuite, Type

STEP = 1.0 / 60.0
# The 128x72 frames: deferred with a small sun map.
RENDER_CONFIG = {"renderer": "deferred", "hdrBloom": True,
                 "shadowMapResolution": 64}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process (the Tier-1 run's xdist workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_file(cfg: dict) -> str:
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    return f.name


def _app(cfg, bake=(64, 36), jax=False):
    """A viewer of the test scene, its cluster shadows off (their 48
    512^2 slices take most of a CPU bake), baked at `bake`."""
    cfg = {"clusteredLightsShadows": False, **cfg}
    args = types.SimpleNamespace(scene=None, config=_config_file(cfg),
                                 camera_index=-1, bench_scene=False)
    app = JaxViewer(args) if jax else SceneViewerApplication(args,
                                                             device="cpu")
    if bake:
        app.swapchain_updated(*bake)
    return app


def test_suite_default_roles_pcf_vs_vsm():
    app = _app({"renderer": "deferred", "hdrBloom": False,
                "shadowMapResolution": 32})
    s = app.renderer_suite
    assert s.get(Type.Deferred) is not None
    assert s.get(Type.DeferredLighting) is not None
    assert s.get(Type.ShadowDepthDirectionalPCF) is not None
    assert s.get(Type.ShadowDepthDirectionalVSM) is None
    assert s.shadow_renderer() is s.get(Type.ShadowDepthDirectionalPCF)

    app2 = _app({"renderer": "deferred", "hdrBloom": False,
                 "shadowMapResolution": 32,
                 "directionalLightShadowsVSM": True})
    s2 = app2.renderer_suite
    assert s2.get(Type.ShadowDepthDirectionalVSM) is not None
    assert s2.config.directional_light_vsm


def test_suite_override_renderer_drives_graph():
    """set_renderer replaces a role before the bake (the reference's
    escape hatch): the re-baked graph runs the override."""
    calls = []
    app = _app({"renderer": "forward", "hdrBloom": False,
                "directionalLightShadows": False,
                "shadowMapResolution": 32})
    orig = app.renderer_suite.get(Type.ForwardOpaque)

    def spy(ctx):
        calls.append("forward")
        return orig(ctx)

    app.renderer_suite.set_renderer(Type.ForwardOpaque, spy)
    app.swapchain_updated(32, 18)
    assert app.renderer_suite.get(Type.ForwardOpaque) is spy
    app.render_frame(STEP, 0.0)
    assert calls == ["forward"]


def test_main_geometry_selection():
    s = RendererSuite()
    sentinel = {}
    for t in Type:
        s.set_renderer(t, lambda ctx, t=t: sentinel.setdefault(t, 1))
    assert s.main_geometry_renderer(True, False) is s.get(Type.Deferred)
    assert s.main_geometry_renderer(True, True) is s.get(
        Type.MotionVector)
    assert s.main_geometry_renderer(False, False) is s.get(
        Type.ForwardOpaque)
    s.config = Config(directional_light_vsm=True)
    assert s.shadow_renderer() is s.get(Type.ShadowDepthDirectionalVSM)


def _bindings(suite, types_) -> dict:
    return {t.name: getattr(suite.get(t), "__name__", None)
            for t in types_}


@pytest.mark.parametrize("knobs", [
    {"renderer": "deferred"},
    {"renderer": "forward", "directionalLightShadowsVSM": True},
    {"renderer": "deferred", "postAA": "taa",
     "directionalLightShadowsCascaded": True, "PCFKernelWide": True,
     "forwardDepthPrepass": True}])
def test_roles_bind_the_jax_executors(knobs):
    """Every role names the same pass method as in the JAX viewer's suite
    (MotionVector the G-buffer pass, PrepassDepth the shadow pass), with
    the same Config, and each graph pass runs the executor its role
    names."""
    cfg = {"hdrBloom": False, "shadowMapResolution": 32, **knobs}
    port, ref = _app(cfg), _app(cfg, jax=True)
    assert _bindings(port.renderer_suite, Type) == \
        _bindings(ref.renderer_suite, JaxType)
    assert vars(port.renderer_suite.config) == \
        vars(ref.renderer_suite.config)
    for name in ("shadow-main", "gbuffer", "lighting", "forward"):
        if name in port.graph._passes:
            assert port.graph._passes[name]._execute.__name__ == \
                ref.graph._passes[name]._execute.__name__


def _frame(app):
    app.swapchain_updated(128, 72)
    return app.render_frame(STEP, 0.0)


def test_default_roles_set_again_render_the_same_frame():
    app = _app(RENDER_CONFIG, bake=None)
    want = _frame(app)
    for t in Type:
        fn = app.renderer_suite.get(t)
        if fn is not None:
            app.renderer_suite.set_renderer(t, fn)
    assert torch.equal(_frame(app), want)


def test_overridden_lighting_role_changes_the_frame():
    app = _app(RENDER_CONFIG, bake=None)
    want = _frame(app)
    lighting = app.renderer_suite.get(Type.DeferredLighting)

    def dim(ctx):
        out = lighting(ctx)
        return {**out, "hdr": out["hdr"] * 0.25}

    app.renderer_suite.set_renderer(Type.DeferredLighting, dim)
    got = _frame(app)
    assert app.graph._passes["lighting"]._execute is dim
    assert got.shape == want.shape
    assert (got[..., :3].int() - want[..., :3].int()).abs().amax() > 8


@pytest.mark.parametrize("on", [False, True])
def test_forward_depth_prepass_reaches_the_suite(on):
    app = _app({"renderer": "forward", "hdrBloom": False,
                "shadowMapResolution": 32, "forwardDepthPrepass": on})
    assert app.config.forward_depth_prepass is on
    assert app.renderer_suite.config.forward_z_prepass is on
