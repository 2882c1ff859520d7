"""Port parity for the deferred post-processing slice: TAA and its
jitter, motion vectors, volumetric fog, FSR2, SSAO, SSR, the post-upscale
sharpen and the positional light term — granite_tpu_torch against the
JAX package on the same seeded inputs — and the golden configs
deferred_taa_fog, deferred_fsr2 and deferred_ssao_ssr rendered by the
port against the JAX render and the committed PNGs (48 dB luma gate,
tests/test_golden_images.py), plus a camera that moves between frames
under TAA.  Tolerances are stated per test."""

import json
import os
import tempfile
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from golden_utils import (
    CONFIGS, FRAMES, GOLDEN_DIR, SIZE, TIME_STEP, psnr, render_config,
)
from granite_tpu.app.scene_viewer import (
    SceneViewerApplication as JaxViewer,
)
from granite_tpu.math.muglm import look_at_matrix, perspective
from granite_tpu.ops import clusterer as JC
from granite_tpu.ops import fsr2 as JF
from granite_tpu.ops import hdr as JH
from granite_tpu.ops import shadow as JSH
from granite_tpu.ops import ssao as JAO
from granite_tpu.ops import ssr as JSR
from granite_tpu.ops import taa as JT
from granite_tpu.ops import volumetric_fog as JV
from granite_tpu.renderer import scene_renderer as JR
from granite_tpu.utils.image_io import load_image
from granite_tpu_torch import convert
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.ops import clusterer as TC
from granite_tpu_torch.ops import fsr2 as TF
from granite_tpu_torch.ops import hdr as TH
from granite_tpu_torch.ops import ssao as TAO
from granite_tpu_torch.ops import ssr as TSR
from granite_tpu_torch.ops import taa as TT
from granite_tpu_torch.ops import volumetric_fog as TV
from granite_tpu_torch.renderer import scene_renderer as TR

GATE_DB = 48.0
H, W = 9, 16


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol, atol=None):
    """Elementwise |got - want| <= atol + rtol * |want|; atol defaults to
    rtol times the reference's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if atol is None:
        atol = rtol * max(float(np.abs(want).max()), 1.0)
    assert np.all(np.isfinite(got) == np.isfinite(want))
    fin = np.isfinite(want)
    assert np.allclose(got[fin], want[fin], rtol=rtol, atol=atol), \
        float(np.abs(got[fin] - want[fin]).max())


def _camera(eye=(3.0, 2.0, 6.0), center=(0.0, 0.5, 0.0), aspect=16 / 9):
    view = look_at_matrix(np.asarray(eye, np.float32),
                          np.asarray(center, np.float32),
                          np.asarray([0.0, 1.0, 0.0], np.float32))
    proj = perspective(np.pi / 3, aspect, 0.1)
    return view.astype(np.float32), proj.astype(np.float32)


# -- jitter -------------------------------------------------------------------

@pytest.mark.parametrize("aa", ["taa", "taa-extreme"])
def test_temporal_jitter_matches_exactly(aa):
    """Exact: a full 8- or 16-phase cycle (plus one) of jittered matrices,
    reprojection matrices and jitter UVs, with the camera moving."""
    table = {"taa": "JITTER_TAA_8PHASE",
             "taa-extreme": "JITTER_TAA_16PHASE"}[aa]
    assert np.array_equal(getattr(JT, table), getattr(TT, table))
    j = JT.TemporalJitter(getattr(JT, table), 96, 54)
    t = TT.TemporalJitter(getattr(TT, table), 96, 54)
    rng = np.random.RandomState(5)
    for _ in range(len(getattr(JT, table)) + 1):
        vp = (rng.randn(4, 4) + 4 * np.eye(4)).astype(np.float32)
        assert np.array_equal(j.step(vp), t.step(vp))
        assert np.array_equal(j.reproject_matrix(), t.reproject_matrix())
        assert np.array_equal(j.last_jitter_uv(), t.last_jitter_uv())
    j.unstep()
    t.unstep()
    assert j.phase == t.phase
    for name in ("JITTER_FXAA_2PHASE", "JITTER_SMAA_T2X"):
        assert np.array_equal(getattr(JT, name), getattr(TT, name))


@pytest.mark.parametrize("render_w,display_w", [(96, 128), (1440, 1920),
                                                (64, 64), (50, 128)])
def test_fsr2_jitter_phases_match_exactly(render_w, display_w):
    assert np.array_equal(JF.fsr2_jitter_phases(render_w, display_w),
                          TF.fsr2_jitter_phases(render_w, display_w))


# -- TAA ----------------------------------------------------------------------

def test_taa_color_space_round_trip():
    """1e-6: TAA space matches the reference; the round trip holds to
    1e-4 for colours below the 0.999 clip (max channel < 124)."""
    c = np.random.RandomState(1).uniform(0, 100, (H, W, 3)).astype(
        np.float32)
    t = TT.hdr_to_taa(_t(c))
    _close(t.numpy(), JT.hdr_to_taa(jnp.asarray(c)), 1e-6)
    back = TT.taa_to_hdr(t).numpy()
    _close(back, JT.taa_to_hdr(jnp.asarray(t.numpy())), 1e-6)
    assert np.allclose(back, c, rtol=1e-4, atol=1e-4)


def _taa_inputs(seed=2):
    rng = np.random.RandomState(seed)
    cur = (rng.uniform(0, 3, (H, W, 3)) ** 2).astype(np.float32)
    prev = np.asarray(JT.hdr_to_taa(jnp.asarray(
        rng.uniform(0, 4, (H, W, 3)).astype(np.float32))))
    depth = rng.uniform(0.0, 0.2, (H, W)).astype(np.float32)
    depth[2, 3:7] = 0.0                                   # background
    return cur, prev, depth


def test_taa_resolve_camera_reprojection_matches():
    """rtol/atol 1e-5, the mv=None branch: a camera reprojection, and a
    reprojection with w = nearest depth - 0.1, which is 0 on the rows
    next to a depth-0.1 row and negative or positive elsewhere (the
    reference's 0 * x / 1e-12 and sign semantics)."""
    cur, prev, depth = _taa_inputs()
    depth[4] = np.float32(0.1)
    depth[3] = depth[5] = np.minimum(depth[3], 0.05)
    rng = np.random.RandomState(3)
    j = JT.TemporalJitter(JT.JITTER_TAA_8PHASE, W, H)
    view, proj = _camera()
    j.step(proj @ view)
    view2, _ = _camera(eye=(3.1, 2.0, 5.9))
    j.step(proj @ view2)
    w0 = np.eye(4, dtype=np.float32) + 0.01 * rng.randn(4, 4).astype(
        np.float32)
    w0[3] = [0.0, 0.0, 1.0, -0.1]
    ref = jax.jit(lambda c, p, d, r: JT.taa_resolve(c, p, d, r, W, H))
    for reproj in (j.reproject_matrix(), w0):
        want = ref(cur, prev, depth, reproj)
        got = TT.taa_resolve(_t(cur), _t(prev), _t(depth), _t(reproj), W, H)
        for g, w in zip(got, want):
            _close(g.numpy(), w, 1e-5, 1e-5)


def test_taa_resolve_motion_vectors_match():
    """rtol/atol 1e-5, the mv branch, with motion vectors that send some
    pixels off screen and ties in the nearest-depth dilation."""
    cur, prev, depth = _taa_inputs(4)
    depth[5, 5] = depth[5, 6] = 0.3
    mv = np.random.RandomState(6).uniform(-0.2, 0.2, (H, W, 2)).astype(
        np.float32)
    mv[0, 0] = [2.0, -3.0]
    reproj = np.eye(4, dtype=np.float32)
    want = jax.jit(lambda c, p, d, r, m: JT.taa_resolve(
        c, p, d, r, W, H, mv=m))(cur, prev, depth, reproj, mv)
    got = TT.taa_resolve(_t(cur), _t(prev), _t(depth), _t(reproj), W, H,
                         mv=_t(mv))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5, 1e-5)


def test_motion_vectors_match():
    """rtol/atol 1e-5: covered pixels reproject their last-frame position,
    the rest the depth buffer; w = 0 positions included."""
    rng = np.random.RandomState(7)
    view, proj = _camera()
    view2, _ = _camera(eye=(3.2, 2.1, 6.0))
    j = JT.TemporalJitter(JT.JITTER_TAA_8PHASE, W, H)
    j.step(proj @ view)
    j.step(proj @ view2)
    remap = np.array([[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5],
                      [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    assert np.array_equal(TT.UV_REMAP, remap)
    prev_vp_uv = (remap @ (proj @ view)).astype(np.float32)
    prev_pos = rng.uniform(-2, 2, (H, W, 3)).astype(np.float32)
    eye = np.array([3.0, 2.0, 6.0], np.float32)
    prev_pos[1, 1] = eye                 # on the camera: w = 0
    covered = rng.rand(H, W) > 0.3
    covered[1, 1] = True
    depth = rng.uniform(0.0, 0.1, (H, W)).astype(np.float32)
    want = jax.jit(lambda *a: JR.motion_vectors(*a, W, H))(
        prev_pos, covered, depth, prev_vp_uv, j.reproject_matrix())
    got = TR.motion_vectors(_t(prev_pos), _t(covered), _t(depth),
                            _t(prev_vp_uv), _t(j.reproject_matrix()), W, H)
    _close(got.numpy(), want, 1e-5, 1e-5)


# -- FSR2 ---------------------------------------------------------------------

def test_fsr2_upscale_matches():
    """rtol/atol 1e-5: one upscale step 9x16 -> 12x21 with a jitter, an
    accumulated history and motion, and the RCAS sharpen alone on an image
    with a flat-at-1.0 patch."""
    rng = np.random.RandomState(8)
    color = (rng.uniform(0, 3, (H, W, 3)) ** 2).astype(np.float32)
    depth = rng.uniform(0, 0.2, (H, W)).astype(np.float32)
    mv = rng.uniform(-0.05, 0.05, (H, W, 2)).astype(np.float32)
    oh, ow = 12, 21
    hist = np.concatenate([
        np.asarray(JT.hdr_to_taa(jnp.asarray(rng.uniform(
            0, 3, (oh, ow, 3)).astype(np.float32)))),
        rng.uniform(0, 16, (oh, ow, 1)).astype(np.float32)], -1)
    jit = TF.fsr2_jitter_phases(W, ow)[3] / np.array([W, H], np.float32)
    want = jax.jit(lambda *a: JF.fsr2_upscale(*a, oh, ow))(
        color, depth, mv, hist, jit)
    got = TF.fsr2_upscale(_t(color), _t(depth), _t(mv), _t(hist), _t(jit),
                          oh, ow)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5, 1e-5)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    img[3:6, 4:8] = 1.0
    _close(TF.rcas_sharpen(_t(img)).numpy(),
           jax.jit(lambda x: JF.rcas_sharpen(x, TF.SHARPNESS))(img),
           1e-5, 1e-5)


# -- fog ----------------------------------------------------------------------

def _lights(n=8, seed=9):
    rng = np.random.RandomState(seed)
    spot = np.arange(n) % 3 == 0
    d = rng.randn(n, 3)
    args = (rng.uniform(-6, 6, (n, 3)), rng.uniform(0.5, 4, (n, 3)),
            rng.uniform(2, 12, n), d / np.linalg.norm(d, axis=1)[:, None],
            rng.uniform(0.1, 0.4, n), rng.uniform(0.5, 0.9, n), spot)
    return JC.pack_lights(*args, capacity=8)


def test_positional_light_color_matches():
    """1e-6 relative: every light slot (points, spots, a dead one) at
    random world positions."""
    lights = JC.pack_lights(*[a[:7] for a in (
        np.random.RandomState(10).uniform(-3, 3, (7, 3)),
        np.ones((7, 3)), np.full(7, 5.0), np.tile([0, -1.0, 0], (7, 1)),
        np.full(7, 0.2), np.full(7, 0.6), np.arange(7) % 2 == 0)],
        capacity=8)
    tl = convert.light_buffer(lights)
    pos = np.random.RandomState(11).uniform(-5, 5, (H, W, 3)).astype(
        np.float32)
    for i in range(8):
        wc, wd = JC.positional_light_color(lights, i, jnp.asarray(pos))
        gc, gd = TC.positional_light_color(tl, i, _t(pos))
        _close(gc.numpy(), wc, 1e-6)
        _close(gd.numpy(), wd, 1e-6)


def test_fog_matches():
    """1e-5 relative: the light-density volume on a 12x16x8 grid with the
    PCF-shadowed sun and 8 positional lights, its accumulation, and the
    composite onto a frame (foreground, background and past-range
    depths)."""
    rng = np.random.RandomState(12)
    view, proj = _camera()
    ivp = np.linalg.inv(proj @ view).astype(np.float32)
    sun = np.array([0.35, 0.9, 0.25], np.float32)
    sun /= np.linalg.norm(sun)
    uv_mat = JSH.shadow_uv_transform(JSH.directional_shadow_matrix(
        sun, np.full(3, -20.0), np.full(3, 20.0)))
    smap = rng.uniform(0.2, 0.8, (32, 32)).astype(np.float32)
    lights = _lights()
    cam = np.array([3.0, 2.0, 6.0], np.float32)
    sun_color = np.array([3.0, 2.8, 2.5], np.float32)
    grid = (8, 12, 16)
    density = jax.jit(lambda ivp, cam, sun, col, smap, uv, lights:
                      JV.fog_light_density(ivp, proj, cam, sun, col, smap,
                                           uv, lights, grid=grid))
    want = density(ivp, cam, sun, sun_color, smap, uv_mat, lights)
    got = TV.fog_light_density(
        _t(ivp), proj, _t(cam), _t(sun), _t(sun_color), shadow_map=_t(smap),
        shadow_uv_mat=_t(uv_mat), lights=convert.light_buffer(lights),
        grid=grid)
    _close(got.numpy(), want, 1e-5)
    unshadowed = TV.fog_light_density(
        _t(ivp), proj, _t(cam), _t(sun), _t(sun_color),
        lights=convert.light_buffer(lights), grid=grid)
    assert not torch.allclose(unshadowed, got)      # the map matters
    acc_w = jax.jit(JV.fog_accumulate)(want)
    acc_g = TV.fog_accumulate(got)
    _close(acc_g.numpy(), acc_w, 1e-5)
    color = rng.uniform(0, 2, (H, W, 3)).astype(np.float32)
    wz = rng.uniform(0, 100, (H, W)).astype(np.float32)
    wz[0, :4] = [0.0, 80.0, 1e6, 1e30]
    _close(TV.apply_fog(_t(color), _t(wz), acc_g).numpy(),
           jax.jit(JV.apply_fog)(color, wz, acc_w), 1e-5)


# -- SSAO / SSR ---------------------------------------------------------------

def _depth_field(h, w, seed):
    """A tilted floor with bumps and a background corner, reverse-Z."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    vz = 2.0 + 6.0 * (1 - ys / h) + 0.3 * np.sin(xs / 3.0) \
        + 0.05 * rng.rand(h, w)
    depth = (0.1 / vz).astype(np.float32)
    depth[:3, -5:] = 0.0
    return depth


def test_ssao_matches():
    """rtol/atol 1e-5: half-res AO of a 36x64 depth field and its
    upsample."""
    depth = _depth_field(36, 64, 13)
    want = jax.jit(lambda d: JAO.ssao(d, z_near=0.1, proj_scale=20.0))(
        depth)
    got = TAO.ssao(_t(depth), z_near=0.1, proj_scale=20.0)
    _close(got.numpy(), want, 1e-5, 1e-5)
    assert float(got.min()) < 0.95            # something occludes
    _close(TAO.upsample_ao(got, 36, 64).numpy(),
           jax.jit(lambda a: JAO.upsample_ao(a, 36, 64))(want), 1e-5, 1e-5)


def test_ssr_matches():
    """rtol 1e-5 (atol 1e-5 of the frame's range): a 36x64 reflective
    floor under a perspective camera."""
    h, w = 36, 64
    rng = np.random.RandomState(14)
    depth = _depth_field(h, w, 15)
    hdr = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    n = rng.randn(h, w, 3) * 0.2 + np.array([0.0, 1.0, 0.0])
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    base = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    metal = rng.uniform(0, 1, (h, w)).astype(np.float32)
    rough = rng.uniform(0, 0.5, (h, w)).astype(np.float32)
    view, proj = _camera(eye=(0.0, 1.5, 4.0), center=(0.0, 0.0, -4.0))
    want = jax.jit(lambda *a: JSR.ssr(*a, w, h))(
        hdr, depth, n, base, metal, rough, view, proj)
    got = TSR.ssr(_t(hdr), _t(depth), _t(n), _t(base), _t(metal), _t(rough),
                  _t(view), proj, w, h)
    _close(got.numpy(), want, 1e-5)
    assert np.abs(got.numpy() - hdr).max() > 1e-3    # some rays hit


def test_sharpen_matches():
    img = np.random.RandomState(16).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    _close(TH.sharpen(_t(img)).numpy(), JH.sharpen(jnp.asarray(img)), 1e-6)


# -- the slice end to end -----------------------------------------------------

POST_CONFIGS = ("deferred_taa_fog", "deferred_fsr2", "deferred_ssao_ssr")


def _port_app(cfg):
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    try:
        app = SceneViewerApplication(types.SimpleNamespace(
            config=f.name, bench_scene=False), device="cpu")
    finally:
        os.unlink(f.name)
    app.swapchain_updated(*SIZE)
    return app


@pytest.fixture(scope="module")
def port_renders():
    """The port's golden-config renders, made once for this module."""
    cache = {}

    def render(name):
        if name not in cache:
            app = _port_app(CONFIGS[name])
            out = None
            for i in range(FRAMES):
                out = app.render_frame(TIME_STEP, i * TIME_STEP)
            cache[name] = out.numpy()
        return cache[name]
    return render


@pytest.mark.parametrize("name", POST_CONFIGS)
def test_post_slice_matches_jax_render(name, port_renders):
    got = port_renders(name)
    ref = render_config(CONFIGS[name])
    assert got.shape == ref.shape == (SIZE[1], SIZE[0], 4)
    assert psnr(got, ref) >= GATE_DB


@pytest.mark.parametrize("name", POST_CONFIGS)
def test_post_slice_matches_golden_png(name, port_renders):
    got = port_renders(name)
    golden = load_image(os.path.join(GOLDEN_DIR, f"{name}.png"))
    assert got.shape == golden.shape
    assert psnr(got, golden) >= GATE_DB
    rgb = got[..., :3].astype(np.float32)
    assert np.isfinite(rgb).all() and 1.0 < rgb.mean() < 250.0


def test_moving_camera_taa_matches_jax(port_renders):
    """Frame 2 after the camera moves: non-zero motion vectors and
    reprojection, the port against the JAX viewer (48 dB)."""
    cfg = CONFIGS["deferred_taa_fog"]
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    try:
        ref_app = JaxViewer(types.SimpleNamespace(
            scene=None, config=f.name, camera_index=-1, bench_scene=False))
    finally:
        os.unlink(f.name)
    ref_app.swapchain_updated(*SIZE)
    app = _port_app(cfg)
    outs = []
    for a in (ref_app, app):
        a.render_frame(TIME_STEP, 0.0)
        a.camera.position = a.camera.position + np.array(
            [0.15, 0.05, -0.1], np.float32)
        outs.append(np.asarray(a.render_frame(TIME_STEP, TIME_STEP)))
    ref, got = outs
    assert psnr(got, ref) >= GATE_DB
    # the move changed the image
    assert psnr(got, port_renders("deferred_taa_fog")) < 40.0


@pytest.mark.parametrize("aa", ["taa-extreme", "smaaT2X", "fxaa2phase"])
def test_every_temporal_post_aa_renders(aa):
    """The TAA family's other members: TAA, then SMAA or FXAA for the
    two-phase modes; a finite image that passes the mean gate."""
    app = _port_app({**CONFIGS["deferred_taa_fog"], "postAA": aa,
                     "volumetricFog": False})
    order = app.graph._order
    assert "taa-resolve" in order
    if aa != "taa-extreme":
        ldr = "smaa" if aa == "smaaT2X" else "fxaa"
        assert order.index("taa-resolve") < order.index(ldr)
    out = None
    for i in range(FRAMES):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
    rgb = out.numpy()[..., :3].astype(np.float32)
    assert out.shape == (SIZE[1], SIZE[0], 4)
    assert np.isfinite(rgb).all() and 1.0 < rgb.mean() < 250.0
    assert app._jitter.phase == FRAMES
