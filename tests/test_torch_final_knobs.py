"""The JAX viewer's last knobs in the port, held against the JAX package on
the CPU: rasterMaxVisible "auto" (the capacity rule and a render through
it), envSpecularHalfRes (the tiled route's half-res specular fetch), the
chained frames' checksum of RenderGraph.execute_chain, and hw_verify's
check 3 on it.

Tolerances: the auto capacity is host integer arithmetic, so it is held
exactly; the render at 128x72 at luma PSNR >= 48 dB against the JAX
viewer's fused raster route (GRANITE_FORCE_FUSED_RASTER=1), the only JAX
route that reads the capacity (ROADMAP.md section C); the half-res fetch
at test_torch_sampler.py::test_environment_fetch_matches' 1e-5 (B3's plain
version against JAX's sample_environment on the same half-res inputs,
then each package's resize_bilinear); the checksum within 1e-3 relative
of the float64 sum of the sequential frames, JAX's contract
(tests/test_render_graph.py)."""

import json
import os
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import CONFIGS, FRAMES, SIZE, TIME_STEP, psnr
from granite_tpu.ops import hdr as JH
from granite_tpu.renderer import environment as JE
from granite_tpu_torch import convert
from granite_tpu_torch.app import bench_scene
from granite_tpu_torch.app.scene_viewer import (
    SceneViewerApplication, ViewerConfig,
)
from granite_tpu_torch.graph.render_graph import (
    RenderGraph, RenderGraphError,
)
from granite_tpu_torch.renderer import scene_renderer as TSR
from granite_tpu_torch.scene.scene_formats import AnimationData
from granite_tpu_torch.tools import hw_verify
from granite_tpu_torch.utils.image_io import load_image

GATE_DB = 48.0
SMALL = (64, 36)
# The golden test scene has 10 objects and 10,866 triangles; from here the
# culling census keeps the floor, three cubes and two spheres (4,646
# triangles; 2,474 reach the compaction at 128x72): auto caps it at 8,192.
EYE, TARGET = (8.0, 2.5, 1.5), (3.54, 1.0, -3.54)
AUTO_CAP = 8192


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process (several xdist workers share
    the cores; see tests/test_torch_ocean.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_file(cfg: dict) -> str:
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    return f.name


def _port_app(cfg: dict, size=SIZE, camera=None):
    path = _config_file(cfg)
    try:
        app = SceneViewerApplication(types.SimpleNamespace(
            config=path, bench_scene=False), device="cpu")
    finally:
        os.unlink(path)
    if camera is not None:
        app.camera.look_at(*(np.asarray(c, np.float32) for c in camera))
    app.swapchain_updated(*size)
    return app


def _render(app, frames: int = FRAMES) -> np.ndarray:
    out = None
    for i in range(frames):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
    return out.numpy()


# --- (a) the auto capacity rule -------------------------------------------

# triangles of each object of a made-up scene (37,000 in all)
TRIS = (1000, 5000, 8000, 20000, 3000)
# each step's masks, as lists of visible objects
SEQUENCES = {
    # the 8,192 floor, growth, a smaller worst that must not shrink it,
    # growth past the total (0, uncapped), and 0 staying 0
    "floor, grow, hold, uncap": [[[0]], [[1, 2]], [[0]], [[3]],
                                 [[0, 1, 2, 3, 4]], [[0]], [[1, 2]]],
    # the worst of several masks in one call
    "several masks": [[[0], [2]], [[1], [0, 4]], [[2, 4], [0]]],
    # uncapped at once: 1.5x 23,000 rounds up past the total
    "uncapped first": [[[3, 4]], [[0]], [[2]]],
    # growth in 8,192 steps, then exactly equal needs
    "steps": [[[4]], [[1]], [[2]], [[1, 4]], [[2]], [[0, 1, 4]]],
}


def _fake_viewer(tri_object, indices):
    """What _update_auto_max_visible and _resolved_max_visible read of a
    viewer, in either package."""
    return types.SimpleNamespace(
        packed=types.SimpleNamespace(tri_object=tri_object,
                                     num_objects=len(TRIS), indices=indices),
        config=types.SimpleNamespace(raster_max_visible="auto"),
        graph=types.SimpleNamespace(invalidate_executables=lambda: None),
        _auto_max_visible=None, _tris_per_object=None)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_auto_max_visible_matches_jax(name):
    from granite_tpu.app.scene_viewer import (
        SceneViewerApplication as JaxViewer,
    )
    tri_object = np.repeat(np.arange(len(TRIS)), TRIS).astype(np.int32)
    total = len(tri_object)
    jax_app = _fake_viewer(tri_object, np.zeros((total, 3), np.int32))
    port_app = _fake_viewer(torch.as_tensor(tri_object),
                            torch.zeros((total, 3), dtype=torch.int32))
    seen = []
    for step in SEQUENCES[name]:
        masks = []
        for objects in step:
            m = np.zeros(len(TRIS), bool)
            m[objects] = True
            masks.append(m)
        JaxViewer._update_auto_max_visible(jax_app, masks)
        SceneViewerApplication._update_auto_max_visible(port_app, masks)
        assert port_app._auto_max_visible == jax_app._auto_max_visible
        assert SceneViewerApplication._resolved_max_visible(port_app) == \
            JaxViewer._resolved_max_visible(jax_app)
        seen.append(port_app._auto_max_visible)
    # monotone: it grows, and once 0 it stays 0
    capped = [c for c in seen if c]
    assert capped == sorted(capped)
    if 0 in seen:
        assert set(seen[seen.index(0):]) == {0}
    assert all(c % 8192 == 0 and (c == 0 or 8192 <= c < total)
               for c in seen)


def test_check_slice_takes_auto_and_half_res():
    for knobs in ({"rasterMaxVisible": "auto"},
                  {"envSpecularHalfRes": True},
                  {"rasterMaxVisible": 8192}):
        path = _config_file({**CONFIGS["deferred_hdr"], **knobs})
        try:
            ViewerConfig.from_json(path).check_slice()
        finally:
            os.unlink(path)
    for value in ("Auto", "8192", "none"):
        with pytest.raises(NotImplementedError):
            ViewerConfig(raster_max_visible=value).check_slice()


# --- (b) a render through the auto capacity --------------------------------

def test_auto_render_matches_fused_jax(monkeypatch):
    cfg = {**CONFIGS["deferred_hdr"], "rasterMaxVisible": "auto"}
    app = _port_app(cfg, camera=(EYE, TARGET))
    got = _render(app)
    total = int(app.packed.indices.shape[0])
    assert app._auto_max_visible == AUTO_CAP < total
    assert app._resolved_max_visible() == AUTO_CAP
    stats = app.frame_stats()
    assert int(stats["gbuffer"]["visible_overflow"]) == 0
    # The compaction keeps the visible triangles' order: the same frame
    # uncapped is bit-equal.
    full = _render(_port_app({**cfg, "rasterMaxVisible": 0},
                             camera=(EYE, TARGET)))
    assert np.array_equal(got, full)

    from granite_tpu.app.scene_viewer import (
        SceneViewerApplication as JaxViewer,
    )
    monkeypatch.setenv("GRANITE_FORCE_FUSED_RASTER", "1")
    # (the JAX viewer watches its config file: it stays until the end)
    path = _config_file(cfg)
    try:
        japp = JaxViewer(types.SimpleNamespace(
            scene=None, config=path, camera_index=-1, bench_scene=False))
        japp.camera.look_at(*(np.asarray(c, np.float32)
                              for c in (EYE, TARGET)))
        japp.swapchain_updated(*SIZE)
        for i in range(FRAMES):
            ref = np.asarray(japp.render_frame(TIME_STEP, i * TIME_STEP))
            japp.post_frame()
    finally:
        os.unlink(path)
    assert japp._auto_max_visible == AUTO_CAP
    assert psnr(got, ref) >= GATE_DB


# --- (c) the half-res specular environment ---------------------------------

@pytest.mark.parametrize("hw", [(36, 64), (37, 53)])
def test_half_res_environment_matches_jax(hw):
    """The tiled route (B3's plain version here) with envSpecularHalfRes:
    at an even size the fetch at every other pixel, uncovered half-res
    pixels 0, upsampled; at an odd size the full-resolution fetch, as in
    the reference."""
    H, W = hw
    je = JE.Environment(JE.procedural_sky_equirect(32))
    strips = convert.environment(je)["strips"]
    rng = np.random.RandomState(5)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    surf = {"normal": torch.as_tensor(nrm),
            "pos": torch.as_tensor(
                rng.uniform(-4, 4, (H, W, 3)).astype(np.float32)),
            "roughness": torch.as_tensor(
                rng.uniform(0, 1, (H, W)).astype(np.float32)),
            "covered": torch.as_tensor(rng.uniform(size=(H, W)) < 0.8)}
    cam = torch.tensor([0.5, 2.0, 6.0])
    params = {"camera_pos": cam, "inv_view_proj": torch.eye(4)}
    env = {"strips": strips, "sh": torch.zeros(9, 3),
           "levels": je.num_levels, "sky_params": {}, "tiled": True,
           "half_res": True}
    # background given: the branch that fetches only the reflections
    _irr, spec, _bg = TSR.compute_env_products(
        surf, params, env, W, H, torch.zeros(3))
    refl, lod = TSR.reflection(surf, cam, je.num_levels)
    refl, lod = refl.numpy(), lod.numpy()
    cov = surf["covered"].numpy()
    if H % 2 == 0 and W % 2 == 0:
        refl, lod, cov = refl[::2, ::2], lod[::2, ::2], cov[::2, ::2]
    ref = np.asarray(JE.sample_environment(je.strips, jnp.asarray(refl),
                                           jnp.asarray(lod)))
    ref = np.where(cov[..., None], ref, 0.0).astype(np.float32)
    if ref.shape[:2] != (H, W):
        ref = np.asarray(JH.resize_bilinear(jnp.asarray(ref), H, W))
    assert spec.shape == (H, W, 3)
    assert np.allclose(spec.numpy(), ref, rtol=1e-5, atol=1e-5)
    # The analytic-sky branch of the lighting pass takes the same fetch.
    sky_env = {**env, "sky_params": {"sun_dir": (0.35, 0.9, 0.25)}}
    _irr, spec_sky, bg = TSR.compute_env_products(surf, params, sky_env,
                                                  W, H, None)
    assert torch.equal(spec_sky, spec) and bg.shape == (H, W, 3)


@pytest.mark.parametrize("renderer", ["deferred", "forward"])
def test_viewer_half_res_route(renderer, monkeypatch):
    """envSpecularHalfRes takes the half-res fetch in the lighting of both
    renderers (the reference's fused shade reads it in both), but not in
    the transparent queue (the reference's classic shade does not)."""
    calls = []
    fetch = TSR.half_res_environment

    def counted(*args, **kw):
        calls.append(kw.get("covered") is not None)
        return fetch(*args, **kw)

    monkeypatch.setattr(TSR, "half_res_environment", counted)
    cfg = {**CONFIGS["deferred_hdr"], "renderer": renderer,
           "materialTileSampler": "true", "envSpecularHalfRes": True}
    app = _port_app(cfg, size=SMALL)
    assert app._has_transparent
    half = _render(app, 1)
    assert calls == [True]
    calls.clear()
    full = _render(_port_app({**cfg, "envSpecularHalfRes": False},
                             size=SMALL), 1)
    assert calls == []
    assert not np.array_equal(half, full)
    assert psnr(half, full) >= 30.0


# --- (d) the chain's checksum -----------------------------------------------

CHAIN_CONFIG = {"renderer": "deferred", "hdrBloom": True,
                "shadowMapResolution": 32, "clusteredLightsShadows": False}


def _bounce(app):
    """Bounce one of the ring objects, as the JAX test does: its world
    matrix, the scene bounds and the culling masks move every frame."""
    app.animation_system.start_animation(AnimationData(
        name="bounce", channels=[dict(
            node=2, path="translation", interp="LINEAR",
            times=np.array([0.0, 0.5, 1.0], np.float32),
            values=np.array([[5.0, 1.0, 0.0], [5.0, 3.0, 0.0],
                             [5.0, 1.0, 0.0]], np.float32))]),
        looping=True)


@pytest.mark.parametrize("scene,orbit", [("static", 0.0), ("static", 0.01),
                                         ("animated", 0.0)])
def test_chain_checksum_is_the_frames_sum(scene, orbit):
    def make():
        path = _config_file(CHAIN_CONFIG)
        try:
            app = SceneViewerApplication(types.SimpleNamespace(
                config=path, bench_scene=False), device="cpu")
        finally:
            os.unlink(path)
        if scene == "animated":
            _bounce(app)
        app.swapchain_updated(*SMALL)
        return app

    seq = make()
    frames = [seq.render_frame(1 / 60, i / 60).numpy()
              for i in seq._orbit(4, orbit)]
    chained = make()
    assert chained._last_chain_checksum is None
    last = chained.render_frames_chained(1 / 60, 0.0, 4, camera_orbit=orbit)
    assert np.array_equal(last.numpy(), frames[-1])
    for k in seq._history:
        assert torch.equal(seq._history[k], chained._history[k]), k
    chk = chained._last_chain_checksum
    assert chk.dtype == torch.float32 and chk.dim() == 0
    expect = sum(f.astype(np.float64).sum() for f in frames[:3])
    assert abs(float(chk) - expect) <= 1e-3 * max(abs(expect), 1.0)


def test_execute_chain_sums_all_but_the_last():
    g = RenderGraph()
    g.add_pass("p").add_color_output("backbuffer").set_execute(
        lambda ctx: {"backbuffer": torch.full(
            (2, 3, 4), float(ctx.params["v"]), dtype=torch.float32)})
    g.set_backbuffer_source("backbuffer")
    g.set_backbuffer_dimensions(3, 2)
    g.bake()
    out, hist, chk = g.execute_chain({"v": 1.0}, [{}, {"v": 2.0}, {}], {})
    assert float(out[0, 0, 0]) == 1.0 and hist == {}
    assert float(chk) == 24.0 * 1.0 + 24.0 * 2.0
    out, _hist, chk = g.execute_chain({"v": 5.0}, iter([{}]), {})
    assert float(chk) == 0.0 and float(out.sum()) == 120.0
    with pytest.raises(RenderGraphError):
        g.execute_chain({}, [], {})


def test_debug_graph_chain_keeps_no_checksum(monkeypatch):
    monkeypatch.setenv("GRANITE_DEBUG_GRAPH", "1")
    app = _port_app(CHAIN_CONFIG, size=SMALL)
    app.render_frames_chained(1 / 60, 0.0, 2)
    assert app._last_chain_checksum is None


# --- (e) hw_verify's check 3 ------------------------------------------------

@pytest.fixture
def test_scene_as_bench(monkeypatch):
    """build_bench_scene returns the golden test scene."""
    monkeypatch.setattr(bench_scene, "build_bench_scene",
                        bench_scene.build_default_test_scene)


@pytest.mark.parametrize("checksum", ["kept", "nan"])
def test_hw_verify_reports_the_checksum(checksum, tmp_path,
                                        test_scene_as_bench, monkeypatch):
    if checksum == "nan":
        chain = RenderGraph.execute_chain

        def poisoned(self, *args):
            out, hist, chk = chain(self, *args)
            return out, hist, chk * float("nan")

        monkeypatch.setattr(RenderGraph, "execute_chain", poisoned)
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(CHAIN_CONFIG, f)
    out = str(tmp_path / "out")
    rc = hw_verify.main(["--width", str(SMALL[0]), "--height",
                         str(SMALL[1]), "--frames", "3", "--out", out,
                         "--config", cfg, "--device", "cpu"])
    with open(os.path.join(out, "hw_verify.json")) as f:
        report = json.load(f)
    if checksum == "kept":
        assert rc == 0 and report["ok"] and not report["failures"]
        # frames 0 and 1 summed: about twice the last frame's sum
        last = load_image(report["png"]).astype(np.float64).sum()
        assert 1.0 <= report["chain_checksum"] / last <= 3.0
    else:
        assert rc == 1
        assert report["failures"] == [
            "chain checksum not finite: nan"]
