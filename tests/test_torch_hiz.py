"""The port's HiZ occlusion culling (ops/hiz, renderer/raster_dispatch, the
classic route of renderer/scene_renderer and the viewer's two-phase
occlusionCulling) held against the JAX package on inputs made from a
numpy seed.

Tolerances: the pyramid (a min reduction) and the visibility bits exact;
the projected rects within 1e-6 relative and the nearest depth within
1e-6 (XLA's CPU dot and torch's matmul may round the corner products
differently); the culled viewer at >= 48 dB against the JAX viewer (luma
PSNR, measured 99.00 dB: the images are equal); the culled frame within
1 LSB of the same frame re-rendered with every object in last frame's
visible set (culling is conservative)."""

import json
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import TIME_STEP, psnr
from granite_tpu.math import look_at_matrix, perspective
from granite_tpu.ops import hiz as JH
from granite_tpu.renderer import scene_renderer as JS
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.ops import hiz as TH
from granite_tpu_torch.ops import raster as TR
from granite_tpu_torch.renderer import raster_dispatch as TD
from granite_tpu_torch.renderer import scene_renderer as TS

SEED = 8
GATE_DB = 48.0
SIZE = (96, 64)
FRAMES = 2
CULL_CONFIG = {"renderer": "forward", "hdrBloom": False,
               "shadowMapResolution": 32, "clusteredLightsShadows": False,
               "occlusionCulling": True}
# Cameras over the test scene: one where the ring's near object hides one
# of the others, one close behind it where it hides seven.
EYE_ONE, EYE_SEVEN, TARGET = (7.5, 1.2, 0.0), (6.5, 1.1, 0.0), \
    (0.0, 1.2, 0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process (several xdist workers share
    the cores; see tests/test_torch_ocean.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng():
    return np.random.default_rng(SEED)


@pytest.mark.parametrize("shape", [(64, 96), (45, 67), (135, 240)])
def test_build_hiz_matches(shape):
    depth = _rng().uniform(0.0, 1.0, shape).astype(np.float32)
    depth[: shape[0] // 3, : shape[1] // 2] = 0.0          # background
    want = JH.build_hiz(jnp.asarray(depth))
    got = TH.build_hiz(torch.as_tensor(depth))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))


def _rects(rng, n, width, height):
    """Rects of every size over the target and past it, some with
    coordinates past +-3e9 (near-plane projections)."""
    lo = rng.uniform(-0.2, 1.1, (n, 2)) * [width, height]
    span = rng.uniform(0.0, 1.0, (n, 2)) ** 3 * [width, height]
    rmin, rmax = lo, lo + span
    far = rng.random(n) < 0.15
    rmin[far] = rng.choice([-3e9, -5e9, 1e8], (far.sum(), 2))
    rmax[far] = rng.choice([3e9, 5e9, 7e8], (far.sum(), 2))
    return rmin.astype(np.float32), rmax.astype(np.float32)


def test_occlusion_test_matches():
    rng = _rng()
    width, height = 96, 64
    depth = np.zeros((height, width), np.float32)
    depth[:, : width // 2] = 0.8                     # a near wall
    depth[10:30, 60:90] = rng.uniform(0.2, 0.6, (20, 30))
    rmin, rmax = _rects(rng, 256, width, height)
    max_z = rng.uniform(0.0, 1.0, 256).astype(np.float32)
    want = np.asarray(JH.occlusion_test(
        JH.build_hiz(jnp.asarray(depth)), jnp.asarray(rmin),
        jnp.asarray(rmax), jnp.asarray(max_z), width, height))
    got = TH.occlusion_test(
        TH.build_hiz(torch.as_tensor(depth)), torch.as_tensor(rmin),
        torch.as_tensor(rmax), torch.as_tensor(max_z), width, height)
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size                # both outcomes occur


def test_project_aabbs_matches():
    """Boxes in front of, crossing and behind the camera's near plane."""
    rng = _rng()
    vp = (perspective(np.pi / 3, 1.5, 0.1, 200.0)
          @ look_at_matrix([0, 1, 0], [0, 1, -1], [0, 1, 0])) \
        .astype(np.float32)
    centers = rng.uniform([-20, -5, -60], [20, 8, 10], (200, 3))
    half = rng.uniform(0.05, 4.0, (200, 3))
    # wide, flat boxes in the camera plane: |w| < 1e-6, so the corners
    # divide by w_safe = 1e-6 and land past +-3e9
    centers[:20] = [0.0, 1.0, 0.0] + rng.uniform(-0.5, 0.5, (20, 3)) \
        * [1, 1, 0]
    half[:20] = rng.uniform([40, 0.1, 1e-7], [100, 2, 2e-7], (20, 3))
    mins = (centers - half).astype(np.float32)
    maxs = (centers + half).astype(np.float32)
    want = [np.asarray(a) for a in JH.project_aabbs(
        jnp.asarray(mins), jnp.asarray(maxs), jnp.asarray(vp), 96, 64)]
    got = [t.numpy() for t in TH.project_aabbs(
        torch.as_tensor(mins), torch.as_tensor(maxs), torch.as_tensor(vp),
        96, 64)]
    assert np.array_equal(got[3], want[3])                 # behind
    assert 0 < want[3].sum() < len(want[3])
    for g, w in zip(got[:2], want[:2]):                    # rects
        assert np.allclose(g, w, rtol=1e-6, atol=1e-4)
    assert np.abs(got[0]).max() > 3e9                      # past +-3e9
    assert np.allclose(got[2], want[2], rtol=0, atol=1e-6)  # max_z


def test_rasterize_scene_and_resolve_match():
    """The classic route on the test scene at 96x64, both packages fed
    the same clip-space and world vertices: the visibility buffer (B1's
    plain version, whole and in the bake's triangle chunks, against the
    JAX brute-force raster; they may break a depth tie between two
    triangles differently, at most 2 pixels here)
    and surface_attributes against the JAX classic resolve where the
    triangles agree: position and normal at every pixel (uncovered ones
    extrapolate triangle 0), the material terms at covered pixels (the
    port's fetch skips the others, which no pass reads)."""
    from granite_tpu.app.scene_viewer import (
        build_default_test_scene as jax_scene,
    )
    w, h = SIZE
    info = jax_scene()
    jp = JS.pack_scene(info, texture_size=64)
    tp = TS.pack_scene(info, texture_size=64)
    vp = (perspective(np.pi / 3, w / h, 0.1, 100.0)
          @ look_at_matrix([7.0, 4.0, 9.0], [0.0, 1.0, 0.0], [0, 1, 0])) \
        .astype(np.float32)
    app = SceneViewerApplication(types.SimpleNamespace(
        config=None, bench_scene=False), device="cpu")
    world = app.scene.world[:app.scene.num_nodes]
    nmats = np.linalg.inv(world[:, :3, :3]).transpose(0, 2, 1)
    jx = JS.transform_vertices(jp, jnp.asarray(world), jnp.asarray(nmats),
                               jnp.asarray(vp))
    tx = [torch.as_tensor(np.array(a)) for a in jx]
    mask = np.ones(jp.num_objects, bool)
    mask[-1] = False
    jsetup, jdepth, jtri = JS.rasterize_scene(
        jp, jx[0], jnp.asarray(mask), w, h, use_binned=False)
    tsetup, tdepth, ttri, tstats = TS.rasterize_scene(
        tp, tx[0], torch.as_tensor(mask), w, h)
    assert int(tstats["clamped_entries"]) == 0
    jtri = np.asarray(jtri)
    same = ttri.numpy() == jtri
    assert (~same).sum() <= 2 and (jtri >= 0).sum() > 1000
    assert np.allclose(tdepth.numpy()[same], np.asarray(jdepth)[same],
                       rtol=0, atol=1e-6)
    # the bake's chunked raster (chunks of 1,000 triangles here)
    cdepth, ctri, cstats = TD.rasterize_binned_exact(tsetup, w, h,
                                                     chunk=1000)
    assert (ctri.numpy() != jtri).sum() <= 2
    assert np.array_equal(cdepth.numpy()[same], tdepth.numpy()[same])
    assert int(cstats["clamped_entries"]) == 0
    jsurf = JS.surface_attributes(jp, jsetup, jtri, *jx[1:], w, h)
    tsurf = TS.surface_attributes(tp, tsetup, ttri, *tx[1:], w, h)
    cov = same & (jtri >= 0)
    for k, at in (("pos", same), ("normal", same), ("base_color", cov),
                  ("metallic", cov), ("roughness", cov), ("emissive", cov),
                  ("alpha", cov)):
        g, ref = tsurf[k].numpy()[at], np.asarray(jsurf[k])[at]
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(g - ref).max() <= 1e-5 * scale, k
    assert np.array_equal(tsurf["covered"].numpy(), ttri.numpy() >= 0)


def test_dispatch_bin_window():
    assert TD.bin_window(1920, 1080) == (2, 4)      # 510 tiles
    assert TD.bin_window(2048, 2048) == (2, 8)
    setup = TR.setup_triangles(torch.zeros((3, 4)),
                               torch.zeros((1, 3), dtype=torch.int32),
                               128, 32)
    depth, tri, stats = TD.rasterize_binned_checked(setup, 128, 32)
    assert depth.shape == (32, 128) and int((tri >= 0).sum()) == 0
    assert int(stats["huge_overflow"]) == int(stats["visible_overflow"]) == 0


def _port_app(eye):
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(CULL_CONFIG, f)
    app = SceneViewerApplication(types.SimpleNamespace(
        config=f.name, bench_scene=False), device="cpu")
    app.camera.look_at(np.asarray(eye, np.float32),
                       np.asarray(TARGET, np.float32))
    app.swapchain_updated(*SIZE)
    return app


def test_viewer_occlusion_matches_jax():
    from granite_tpu.app.scene_viewer import (
        SceneViewerApplication as JaxViewer,
    )
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(CULL_CONFIG, f)
    japp = JaxViewer(types.SimpleNamespace(
        scene=None, config=f.name, camera_index=-1, bench_scene=False))
    japp.camera.look_at(np.asarray(EYE_ONE, np.float32),
                        np.asarray(TARGET, np.float32))
    japp.swapchain_updated(*SIZE)
    app = _port_app(EYE_ONE)
    for i in range(FRAMES):
        ref = np.asarray(japp.render_frame(TIME_STEP, i * TIME_STEP))
        japp.post_frame()
        got = app.render_frame(TIME_STEP, i * TIME_STEP).numpy()
    assert int(app.cull_counts["culled"]) == 1
    assert np.array_equal(app._history["vis-history"].numpy(),
                          np.asarray(japp._history["vis-history"]))
    assert psnr(got, ref) >= GATE_DB


def test_culled_frame_matches_all_visible_rerender():
    app = _port_app(EYE_SEVEN)
    app.render_frame(TIME_STEP, 0.0)
    hist = app._history
    culled = app.render_frame(TIME_STEP, TIME_STEP).numpy()
    counts = {k: int(v) for k, v in app.cull_counts.items()}
    assert counts["culled"] >= 5 and counts["phase2"] == 0
    app._history = {**hist, "vis-history": torch.ones_like(
        hist["vis-history"])}
    full = app.render_frame(TIME_STEP, TIME_STEP).numpy()
    assert int(app.cull_counts["culled"]) == 0
    diff = np.abs(culled.astype(int) - full.astype(int)).max()
    assert diff <= 1
