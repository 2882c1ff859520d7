"""The port's shadow knobs held against the JAX package on inputs made
from a numpy seed: the 6x6 windowed PCF (PCFKernelWide), the cascade
matrices and the cascade blend (directionalLightShadowsCascaded), the
VSM shadow atlas of the clustered lights (clusteredLightsShadowsVSM),
and the viewer with them against the JAX viewer.

Tolerances: pcf_wide 1e-6 (the same f32 ops in the same order, but
XLA's exp2 and torch's differ by an ulp; measured 1.2e-7);
sample_directional_shadow, wide or narrow, 1e-5 (measured 3.6e-6: the
world -> uv projection's 3-term dot rounds differently in XLA and torch,
up to 1.9e-6 at these positions, and the window's slope over a 64-texel
map turns that into a few 1e-6 of term; test_torch_shade_fused.py holds
the narrow one at the same 1e-5); cascade_matrices 1e-6 relative
(host numpy on both sides); the cascade blend 1e-5 (four PCF terms and
a cross-fade); the VSM atlas bit-equal, its terms 1e-5 (a Chebyshev
ratio of bilinear moments).  At u, v of +-3e9, +-inf and NaN the wide
kernel casts the start texel as XLA does (saturating) and offsets it in
wrapping int32 before the clip, so every fetch stays inside the map;
those pixels are outside the light frustum and equal JAX's 1.

Viewer renders: 128x72, the golden test scene, 2 frames, luma PSNR >=
48 dB against the JAX viewer (measured on the CPU: deferred_hdr + wide
71.82 dB, forward_shadow + cascades + wide 72.73, forward_vsm_fxaa +
cascades 67.84, deferred_taa_fog + cascades 73.01; shadowTermHalfRes on
the fused route 61.81 narrow and 61.85 wide).  shadowTermHalfRes runs
the JAX render with GRANITE_FORCE_FUSED_RASTER=1, its fused raster
route, the one the JAX viewer takes on the TPU: its CPU route
extrapolates triangle 0 into the sky pixels, whose half-res terms the
upsample blends into silhouettes (ROADMAP.md section C)."""

import json
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import CONFIGS, FRAMES, SIZE, TIME_STEP, psnr, \
    render_config
from granite_tpu.ops import light_shadows as JL
from granite_tpu.ops import shadow as JSH
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.ops import light_shadows as TL
from granite_tpu_torch.ops import shadow as TSH

SEED = 11
GATE_DB = 48.0


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


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol, err


def _smooth_map(rng, s):
    """A depth map with plateaus and slopes, so PCF windows straddle
    edges."""
    yy, xx = np.mgrid[0:s, 0:s] / s
    base = 0.4 + 0.3 * np.sin(7 * xx) * np.cos(5 * yy)
    return (base + 0.05 * rng.uniform(size=(s, s))).astype(np.float32)


def _uvz(rng, shape):
    """u, v over the map and a little past it, receiver depths around
    the map's."""
    u = rng.uniform(-0.05, 1.05, shape).astype(np.float32)
    v = rng.uniform(-0.05, 1.05, shape).astype(np.float32)
    z = rng.uniform(0.2, 0.9, shape).astype(np.float32)
    return u, v, z


def test_pcf_wide_matches():
    rng = _rng()
    smap = _smooth_map(rng, 64)
    u, v, z = _uvz(rng, (24, 40))
    ref = JSH.pcf_wide(jnp.asarray(smap), jnp.asarray(u), jnp.asarray(v),
                       jnp.asarray(z))
    got = TSH.pcf_wide(torch.as_tensor(smap), torch.as_tensor(u),
                       torch.as_tensor(v), torch.as_tensor(z))
    _close(got, ref, 1e-6)
    # through the projection, wide and narrow
    pos = rng.uniform(-6.0, 6.0, (20, 36, 3)).astype(np.float32)
    m = JSH.shadow_uv_transform(JSH.directional_shadow_matrix(
        np.array([0.3, 0.8, 0.5], np.float32), np.full(3, -8.0, np.float32),
        np.full(3, 8.0, np.float32)))
    for wide in (True, False):
        ref = JSH.sample_directional_shadow(jnp.asarray(smap), jnp.asarray(m),
                                            jnp.asarray(pos), wide=wide)
        got = TSH.sample_directional_shadow(
            torch.as_tensor(smap), torch.as_tensor(m), torch.as_tensor(pos),
            wide=wide)
        _close(got, ref, 1e-5)


@pytest.mark.parametrize("value", [3e9, -3e9, float("inf"), float("-inf"),
                                   float("nan")])
def test_pcf_wide_extreme_coordinates(value):
    """u or v past the int32 range once scaled, +-inf or NaN: the cast
    saturates (NaN to 0) and the +-2 block offsets wrap in int32 before
    the clip, as XLA's do; a plain torch cast or int64 offsets would
    fetch other texels (or index out of range)."""
    rng = _rng()
    smap = _smooth_map(rng, 32)
    u, v, z = _uvz(rng, (8, 16))
    u[::2] = value
    v[:, ::3] = value
    ref = JSH.pcf_wide(jnp.asarray(smap), jnp.asarray(u), jnp.asarray(v),
                       jnp.asarray(z))
    got = TSH.pcf_wide(torch.as_tensor(smap), torch.as_tensor(u),
                       torch.as_tensor(v), torch.as_tensor(z))
    ref, got = np.asarray(ref), got.numpy()
    odd = ~np.isfinite(u) | ~np.isfinite(v) | (np.abs(u) > 1e9) \
        | (np.abs(v) > 1e9)
    assert odd.any() and (~odd).any()
    assert np.array_equal(ref[odd], got[odd]) and (got[odd] == 1.0).all()
    _close(got[~odd], ref[~odd], 1e-6)
    # the saturated start texel offset by +2 wraps negative and clips to 0
    big = TSH.saturating_int32(torch.tensor([3e9, -3e9, float("nan")]))
    wrapped = TSH._add_int32(big, 2)
    assert wrapped.dtype == torch.int32
    assert wrapped.tolist() == [-2 ** 31 + 1, -2 ** 31 + 2, 2]
    assert TSH._add_int32(big, -2).tolist() == [2 ** 31 - 3, 2 ** 31 - 2,
                                                -2]


def test_cascade_matrices_match():
    rng = _rng()
    for _ in range(3):
        light = rng.normal(size=3).astype(np.float32)
        cam = rng.uniform(-10, 10, 3).astype(np.float32)
        front = rng.normal(size=3).astype(np.float32)
        front /= np.linalg.norm(front)
        mn = rng.uniform(-30, -5, 3).astype(np.float32)
        mx = rng.uniform(5, 30, 3).astype(np.float32)
        ref = JSH.cascade_matrices(light, cam, front, mn, mx)
        got = TSH.cascade_matrices(light, cam, front, mn, mx)
        assert got.shape == (4, 4, 4) and got.dtype == np.float32
        assert np.allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # the light straight along +y takes the z up vector
    ref = JSH.cascade_matrices([0, 1, 0], cam, front, mn, mx, 2, 4.0)
    assert np.allclose(TSH.cascade_matrices([0, 1, 0], cam, front, mn, mx,
                                            2, 4.0), ref, rtol=1e-6)


@pytest.mark.parametrize("wide", [False, True])
def test_cascaded_shadow_matches(wide):
    rng = _rng()
    light = np.array([0.35, 0.9, 0.25], np.float32)
    cam = np.array([2.0, 1.5, 3.0], np.float32)
    front = np.array([-0.4, -0.2, -0.9], np.float32)
    front /= np.linalg.norm(front)
    vps = TSH.cascade_matrices(light, cam, front, np.full(3, -40.0),
                               np.full(3, 40.0), first_radius=2.0)
    uv = np.stack([TSH.shadow_uv_transform(m) for m in vps])
    maps = np.stack([_smooth_map(rng, 32) for _ in range(4)])
    # receivers from the camera out past the last cascade's footprint
    d = rng.uniform(0.0, 40.0, (16, 24, 1)).astype(np.float32)
    jitter = rng.normal(scale=3.0, size=(16, 24, 3)).astype(np.float32)
    pos = (cam + front * d + jitter).astype(np.float32)
    ref = JSH.sample_cascaded_shadow(jnp.asarray(maps), jnp.asarray(uv),
                                     jnp.asarray(pos), wide=wide)
    got = TSH.sample_cascaded_shadow(torch.as_tensor(maps),
                                     torch.as_tensor(uv),
                                     torch.as_tensor(pos), wide=wide)
    _close(got, ref, 1e-5)
    # some pixels sit in a fade band, some past every cascade (term 1)
    assert 0.0 < float((got < 1.0).float().mean()) < 1.0


def test_vsm_atlas_matches():
    rng = _rng()
    centre = np.array([0.5, 1.0, -0.5], np.float32)
    infos = [{"pos": centre + np.array(o, np.float32),
              "dir": np.array(dv, np.float32), "radius": 6.0,
              "outer": 0.7, "is_spot": spot}
             for o, dv, spot in (((0, 2, 0), (0, -1, 0), True),
                                 ((1, 0.5, 1), (0, -1, 0), False),
                                 ((-2, 1, 0), (1, -1, 0), True),
                                 ((0, 1, -2), (0, -1, 0), False))]
    vps, sl, kd = JL.assign_slices(infos)
    # occluder depths at the receivers' (reverse-Z, near 0.03: ~0.001-0.01)
    slices = np.stack([0.01 * _smooth_map(rng, 16)
                       for _ in range(vps.shape[0])])
    ja = JL.pack_atlas_vsm(jnp.asarray(slices))
    ta = TL.pack_atlas_vsm(torch.as_tensor(slices))
    assert ta.shape == (vps.shape[0] * 16 * 16, 8)
    assert np.array_equal(np.asarray(ja), ta.numpy())
    pos = (centre + rng.uniform(-3.0, 3.0, (12, 20, 3))).astype(np.float32)
    masks = np.full((12, 20, 1), 0b1111, np.uint32)
    masks[::3, ::2] = 0b0110
    light_pos = np.stack([li["pos"] for li in infos])
    js, jt = JL.topk_shadow_terms(ja, vps, 16, 4, sl, kd, light_pos,
                                  jnp.asarray(masks), jnp.asarray(pos), k=2)
    ts, tt = TL.topk_shadow_terms(ta, vps, 16, 4, sl, kd, light_pos,
                                  torch.as_tensor(masks.view(np.int32)),
                                  torch.as_tensor(pos), k=2)
    assert np.array_equal(np.asarray(js), ts.numpy())
    _close(tt, jt, 1e-5)
    # the VSM terms are soft: some strictly between 0 and 1
    assert bool(((tt > 0.0) & (tt < 1.0)).any())


def _render_port(cfg):
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    app = SceneViewerApplication(types.SimpleNamespace(
        config=f.name, bench_scene=False), device="cpu")
    app.swapchain_updated(*SIZE)
    out = None
    for i in range(FRAMES):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
    return app, out.numpy()


CASCADES = {"directionalLightShadowsCascaded": True}
WIDE = {"PCFKernelWide": True}
VIEWER_CONFIGS = {
    "deferred_hdr wide": {**CONFIGS["deferred_hdr"], **WIDE},
    "forward_shadow cascades wide": {**CONFIGS["forward_shadow"],
                                     **CASCADES, **WIDE},
    # the cascaded branch comes before the VSM moments: cascaded PCF
    "forward_vsm_fxaa cascades": {**CONFIGS["forward_vsm_fxaa"], **CASCADES},
    # the fog volume does not read the cascades
    "deferred_taa_fog cascades": {**CONFIGS["deferred_taa_fog"], **CASCADES},
}


@pytest.mark.parametrize("name", sorted(VIEWER_CONFIGS))
def test_viewer_shadow_knobs_match_jax(name):
    cfg = VIEWER_CONFIGS[name]
    app, got = _render_port(cfg)
    ref = render_config(cfg)
    assert got.shape == ref.shape == (SIZE[1], SIZE[0], 4)
    assert psnr(got, ref) >= GATE_DB
    if cfg.get("directionalLightShadowsCascaded"):
        s = int(cfg["shadowMapResolution"])
        assert app._param_cache[1]["cascade_vps"].shape == (4, 4, 4)
        assert "static_shadow_depth" not in app._param_cache[1]
        assert app.graph._resources["shadow-depth"].info.shape(*SIZE) == (
            4, s, s)
        if "fog-volume" in app.graph._order:
            assert "shadow-depth" not in \
                app.graph._passes["fog-volume"].inputs


@pytest.mark.parametrize("wide", [False, True])
def test_shadow_term_half_res_matches_fused_jax(wide, monkeypatch):
    cfg = {**CONFIGS["deferred_hdr"], "shadowTermHalfRes": True,
           **(WIDE if wide else {})}
    _app, got = _render_port(cfg)
    monkeypatch.setenv("GRANITE_FORCE_FUSED_RASTER", "1")
    ref = render_config(cfg)
    assert psnr(got, ref) >= GATE_DB
