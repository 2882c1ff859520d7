"""The port's FFT ocean and terrain (ops/fft, ops/ocean, renderer/ocean,
renderer/ground, the ops/texture mip-stack samplers) held against the JAX
package on inputs made from a numpy seed, and the deferred_ocean_ground
golden config rendered end to end on the CPU against the JAX render and
the golden PNG.

Tolerances: the FFTs under the reference's SNR gate (squared error <=
1e-10 of the signal power); the numpy builders byte-equal; the ocean maps
within 1e-4 of their largest magnitude; displacement and samplers within
1e-4 (jnp.fft and XLA's CPU contractions round differently from
torch.fft and torch)."""

import json
import os
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import CONFIGS, FRAMES, GOLDEN_DIR, SIZE, TIME_STEP, \
    psnr, render_config
from granite_tpu.ops import fft as JF
from granite_tpu.ops import ocean as JO
from granite_tpu.ops import texture as JT
from granite_tpu.renderer import ground as JG
from granite_tpu.renderer.ocean import Ocean as JaxOcean
from granite_tpu.renderer.ocean import OceanConfig as JaxOceanConfig
from granite_tpu.utils.image_io import load_image
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.ops import fft as TF
from granite_tpu_torch.ops import ocean as TO
from granite_tpu_torch.ops import texture as TT
from granite_tpu_torch.renderer import ground as TG
from granite_tpu_torch.renderer.ocean import Ocean, OceanConfig

GATE_DB = 48.0
SEED = 6


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


def _rng():
    return np.random.default_rng(SEED)


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol, err


def _complex(rng, shape):
    return (rng.normal(size=shape)
            + 1j * rng.normal(size=shape)).astype(np.complex64)


FFT_CASES = {
    "fft_1d": lambda m, x, r: m.fft_1d(x),
    "ifft_1d": lambda m, x, r: m.fft_1d(x, m.Direction.INVERSE),
    "fft_1d_axis0": lambda m, x, r: m.fft_1d(x, axis=0),
    "fft_2d": lambda m, x, r: m.fft_2d(x),
    "ifft_2d": lambda m, x, r: m.fft_2d(x, m.Direction.INVERSE),
    "fft_3d": lambda m, x, r: m.fft_3d(x),
    "ifft_3d": lambda m, x, r: m.fft_3d(x, m.Direction.INVERSE),
    "r2c_1d": lambda m, x, r: m.r2c_1d(r),
    "c2r_1d": lambda m, x, r: m.c2r_1d(m.r2c_1d(r), r.shape[-1]),
    "r2c_2d": lambda m, x, r: m.r2c_2d(r),
    "c2r_2d": lambda m, x, r: m.c2r_2d(m.r2c_2d(r), r.shape[-2:]),
}


@pytest.mark.parametrize("name", sorted(FFT_CASES))
def test_fft_matches_jax(name):
    rng = _rng()
    x = _complex(rng, (4, 16, 32))
    r = rng.normal(size=(4, 16, 32)).astype(np.float32)
    fn = FFT_CASES[name]
    got = fn(TF, torch.as_tensor(x), torch.as_tensor(r))
    want = np.asarray(fn(JF, jnp.asarray(x), jnp.asarray(r)))
    assert tuple(got.shape) == want.shape
    assert TF.snr_check(got, want, 1e-10)
    assert JF.snr_check(want, got.numpy(), 1e-10)


@pytest.mark.parametrize("n,world,amp,wind,seed", [
    (64, (64.0, 64.0), 0.3, (6.0, 3.0), 0),
    (32, (40.0, 20.0), 1.1, (-2.0, 7.5), 5)])
def test_generate_distribution_bytes(n, world, amp, wind, seed):
    got = TO.generate_distribution(n, world, amp, wind, seed=seed)
    want = JO.generate_distribution(n, world, amp, wind, seed=seed)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.array_equal(TO.alias_freq(n), JO.alias_freq(n))


def _small_config(cls):
    return cls(fft_resolution=64, grid_resolution=12, world_size=32.0)


def test_grid_mesh_bytes():
    got = Ocean(_small_config(OceanConfig)).grid_mesh(3)
    want = JaxOcean(_small_config(JaxOceanConfig)).grid_mesh(3)
    for f in ("positions", "normals", "uvs", "tangents", "indices",
              "aabb_min", "aabb_max"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert got.material == want.material == 3


@pytest.mark.parametrize("t", [0.0, 37.25])
def test_ocean_maps(t):
    n, ws = 64, (48.0, 48.0)
    h0 = JO.generate_distribution(n, ws, 0.5, (5.0, 2.0), seed=SEED)
    jk = JO._freq_grids(n, ws)
    tk = TO._freq_grids(n, ws)
    for a, b in zip(tk, jk):
        assert np.array_equal(a.numpy(), np.asarray(b))
    want = JO.ocean_maps(jnp.asarray(h0), *jk, jnp.float32(t))
    got = TO.ocean_maps(torch.as_tensor(h0), *tk,
                        torch.tensor(t, dtype=torch.float32))
    for g, w in zip(got, want):
        w = np.asarray(w)
        _close(g, w, 1e-4 * float(np.abs(w).max()))


def _ocean_pair():
    jo = JaxOcean(_small_config(JaxOceanConfig))
    to = Ocean(_small_config(OceanConfig))
    return jo, to


def test_fft_pass_mip_stack():
    jo, to = _ocean_pair()
    ctx_j = types.SimpleNamespace(params={"ocean_time": jnp.float32(3.5)})
    ctx_t = types.SimpleNamespace(params={"ocean_time": torch.tensor(3.5)})
    want = np.asarray(jo.fft_pass(ctx_j)["ocean-maps"])
    got = to.fft_pass(ctx_t)["ocean-maps"]
    assert got.shape == want.shape == (6, 64, 64, 5)
    _close(got, want, 1e-4 * float(np.abs(want).max()))


def _vertices(rng, n, extent):
    pos = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.7
    return pos, nrm, mask


@pytest.mark.parametrize("with_camera", [False, True])
def test_ocean_displace(with_camera):
    rng = _rng()
    jo, to = _ocean_pair()
    maps = np.array(jo.fft_pass(types.SimpleNamespace(
        params={"ocean_time": jnp.float32(1.5)}))["ocean-maps"])
    pos, nrm, mask = _vertices(rng, 700, 40.0)
    cam = np.array([3.0, 12.0, -30.0], np.float32)
    want = jo.displace(jnp.asarray(pos), jnp.asarray(nrm),
                       jnp.asarray(mask), jnp.asarray(maps),
                       camera_pos=jnp.asarray(cam) if with_camera else None)
    got = to.displace(torch.as_tensor(pos), torch.as_tensor(nrm),
                      torch.as_tensor(mask), torch.as_tensor(maps),
                      camera_pos=torch.as_tensor(cam) if with_camera
                      else None)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    h, dx, dz, grad = TO.sample_heightfield(
        *(torch.as_tensor(maps[0, ..., s]) for s in (0, slice(1, 3),
                                                     slice(3, 5))),
        torch.as_tensor(pos[:, 0] / 40.0), torch.as_tensor(pos[:, 2] / 40.0),
        1.2)
    want = JO.sample_heightfield(
        *(jnp.asarray(maps[0, ..., s]) for s in (0, slice(1, 3),
                                                 slice(3, 5))),
        jnp.asarray(pos[:, 0] / 40.0), jnp.asarray(pos[:, 2] / 40.0), 1.2)
    for g, w in zip((h, dx, dz, grad), want):
        _close(g, w, 1e-4)


def test_ground_lod_displace():
    rng = _rng()
    hm = JG.fbm_heightmap(64, amplitude=2.5, seed=SEED)
    jg = JG.GroundLOD(hm, world_size=40.0, grid=16, max_lod=4.0,
                      base_patch_size=32)
    tg = TG.GroundLOD(hm, world_size=40.0, grid=16, max_lod=4.0,
                      base_patch_size=32)
    _close(tg.maps, jg.maps, 1e-5)
    assert tg.lod0_distance == jg.lod0_distance
    pos, nrm, mask = _vertices(rng, 700, 30.0)
    cam = np.array([-4.0, 300.0, 25.0], np.float32)   # far: coarse lods
    want = jg.displace(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(mask),
                       jnp.asarray(cam))
    got = tg.displace(torch.as_tensor(pos), torch.as_tensor(nrm),
                      torch.as_tensor(mask), torch.as_tensor(cam))
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("seed,amp", [(0, 2.5), (9, 1.0)])
def test_heightmap_and_ground_meshes(seed, amp):
    hm = TG.fbm_heightmap(128, seed=seed, amplitude=amp)
    want = JG.fbm_heightmap(128, seed=seed, amplitude=amp)
    assert hm.dtype == want.dtype and np.array_equal(hm, want)
    for got, ref in ((TG.ground_mesh(hm, 80.0, 24, 2),
                      JG.ground_mesh(want, 80.0, 24, 2)),
                     (TG.flat_grid_mesh(80.0, 24, 2),
                      JG.flat_grid_mesh(80.0, 24, 2))):
        for f in ("positions", "normals", "uvs", "tangents", "indices",
                  "aabb_min", "aabb_max"):
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("wrap", [TT.WRAP_REPEAT, TT.WRAP_CLAMP])
def test_mip_stack_samplers(wrap):
    rng = _rng()
    img = rng.normal(size=(32, 16, 3)).astype(np.float32)
    want_m = np.asarray(JT.build_mips(jnp.asarray(img)))
    got_m = TT.build_mips(torch.as_tensor(img))
    _close(got_m, want_m, 1e-6)
    u = rng.uniform(-1.5, 2.5, 500).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, 500).astype(np.float32)
    lod = rng.uniform(-1.0, 7.0, 500).astype(np.float32)
    lvl = rng.integers(-1, 7, 500).astype(np.int32)
    _close(TT.sample_level(got_m, torch.as_tensor(u), torch.as_tensor(v),
                           torch.as_tensor(lvl), wrap),
           JT.sample_level(jnp.asarray(want_m), jnp.asarray(u),
                           jnp.asarray(v), jnp.asarray(lvl), wrap), 1e-5)
    _close(TT.sample_trilinear(got_m, torch.as_tensor(u), torch.as_tensor(v),
                               torch.as_tensor(lod), wrap),
           JT.sample_trilinear(jnp.asarray(want_m), jnp.asarray(u),
                               jnp.asarray(v), jnp.asarray(lod), wrap),
           1e-5)


# ---------------------------------------------------------------------------
# The golden config end to end
# ---------------------------------------------------------------------------

def _app(cfg):
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    try:
        return SceneViewerApplication(types.SimpleNamespace(
            config=f.name, bench_scene=False), device="cpu")
    finally:
        os.unlink(f.name)


def _render(cfg):
    app = _app(cfg)
    app.swapchain_updated(*SIZE)
    out = None
    for i in range(FRAMES):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
    return out.numpy()


def test_ocean_ground_matches_jax_render():
    """deferred_ocean_ground against the JAX render: both take the
    reference's untiled route on the CPU (materialTileSampler "auto"),
    whose specular environment fetch runs at every other pixel; the
    ocean's high-frequency normals would expose any other route."""
    cfg = CONFIGS["deferred_ocean_ground"]
    got = _render(cfg)
    want = render_config(cfg)
    assert got.shape == want.shape == (SIZE[1], SIZE[0], 4)
    assert psnr(got, want) >= GATE_DB


def test_ocean_ground_golden_png():
    got = _render(CONFIGS["deferred_ocean_ground"])
    golden = load_image(os.path.join(GOLDEN_DIR,
                                     "deferred_ocean_ground.png"))
    assert got.shape == golden.shape
    assert psnr(got, golden) >= GATE_DB


def test_ocean_frames_follow_elapsed_time():
    """Two ocean_ground frames at different elapsed times differ, and a
    still camera does not reuse the param cache while an ocean exists
    (the ocean time rides the params)."""
    app = _app(CONFIGS["deferred_ocean_ground"])
    app.swapchain_updated(64, 36)
    a = app.render_frame(TIME_STEP, 0.0).numpy()
    p0 = app._param_cache[1]
    b = app.render_frame(TIME_STEP, 2.0).numpy()
    p1 = app._param_cache[1]
    assert p0 is not p1
    assert float(p0["ocean_time"]) == 0.0 and float(p1["ocean_time"]) == 2.0
    assert np.abs(a.astype(int) - b).max() > 8
    # the chained path gives frame i the time t0 + i * frame_time
    c = app.render_frames_chained(TIME_STEP, 2.0 - TIME_STEP, 2).numpy()
    app2 = _app(CONFIGS["deferred_ocean_ground"])
    app2.swapchain_updated(64, 36)
    for t in (0.0, 2.0, 2.0 - TIME_STEP):
        app2.render_frame(TIME_STEP, t)
    d = app2.render_frame(TIME_STEP, 2.0).numpy()
    assert np.array_equal(c, d)


@pytest.mark.parametrize("lod", [False, True])
def test_add_terrain_matches_jax(lod):
    """The viewer's terrain composition, baked or with the LOD displacer
    (a scene file's terrain {"lod": true}), on the test scene: the same
    material, mesh, node and displacer as the JAX viewer's."""
    from granite_tpu.app.scene_viewer import (
        SceneViewerApplication as JaxViewer, build_default_test_scene,
    )
    from granite_tpu_torch.app import bench_scene as TB
    cfg = {"lod": lod, "grid": 16, "worldSize": 40.0, "amplitude": 1.5,
           "maxLod": 3.0, "basePatchSize": 32, "seed": 2}
    apps = [types.SimpleNamespace(_terrain_cfg=cfg, ground=None, device="cpu")
            for _ in range(2)]
    infos = [build_default_test_scene(), TB.build_default_test_scene()]
    JaxViewer._add_terrain(apps[0], infos[0])
    SceneViewerApplication._add_terrain(apps[1], infos[1])
    want, got = infos
    assert len(got.meshes) == len(want.meshes)
    for f in ("positions", "normals", "uvs", "indices", "aabb_min",
              "aabb_max"):
        a, b = getattr(got.meshes[-1], f), getattr(want.meshes[-1], f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in ((got.materials[-1], want.materials[-1]),
                 (got.nodes[-1], want.nodes[-1])):
        assert a.name == b.name
    assert np.array_equal(got.nodes[-1].translation,
                          want.nodes[-1].translation)
    assert got.nodes[got.roots[0]].children == \
        want.nodes[want.roots[0]].children
    if lod:
        assert apps[1]._ground_node == apps[0]._ground_node
        _close(apps[1].ground.maps, apps[0].ground.maps, 1e-5)
        assert apps[1].ground.lod0_distance == apps[0].ground.lod0_distance
    else:
        assert apps[0].ground is None and apps[1].ground is None
