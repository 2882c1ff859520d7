"""The port's volumetric fog regions (ops/volumetric_fog.region_fog_density
and the viewer's default region) and volumetric diffuse GI
(renderer/volumetric_diffuse, the viewer's probe bake through the
classic route, B3 and B4) held against the JAX package on inputs made
from a numpy seed.

Tolerances: the ambient-cube integral, the oct packing, the volume
sampler and the region density within 1e-5 (relative to the largest
magnitude, at least 1); the baked ambient cubes within 2e-3 of their
largest value, at least 1 (measured 8.8e-4 against a largest value of
0.69: the faces' shading goes through B4's plain version here and the
JAX classic shade there, whose sums round differently, and an 8x8 face
magnifies a small difference in a texel's shade); the viewer renders at
>= 48 dB luma PSNR against the JAX viewer (measured: fog regions 99.00
dB, volumetric diffuse 72.03 dB), at the settings of
tests/test_volumetric_fog.py and tests/test_volumetric_diffuse.py."""

import json
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import psnr
from granite_tpu.ops import volumetric_fog as JF
from granite_tpu.renderer import volumetric_diffuse as JV
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.ops import volumetric_fog as TF
from granite_tpu_torch.renderer import volumetric_diffuse as TV

SEED = 9
GATE_DB = 48.0
SIZE = (96, 54)
BASE = {"renderer": "forward", "hdrBloom": False, "shadowMapResolution": 32,
        "clusteredLightsShadows": False}
FOG_REGIONS = {**BASE, "volumetricFog": True, "volumetricFogRegions": True}
DIFFUSE = {**BASE, "volumetricDiffuse": True,
           "volumetricDiffuseResolution": 2,
           "volumetricDiffuseFaceResolution": 8}


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


def _close(got, want, tol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, err


def test_ambient_cube_integral_matches():
    faces = _rng().uniform(0.0, 3.0, (6, 8, 8, 3)).astype(np.float32)
    _close(TV.ambient_cube_integral(torch.as_tensor(faces)),
           JV.ambient_cube_integral(jnp.asarray(faces)))
    # a batch of probes integrates each probe's faces on its own
    batch = _rng().uniform(0.0, 3.0, (2, 3, 6, 8, 8, 3)).astype(np.float32)
    got = TV.ambient_cube_integral(torch.as_tensor(batch))
    assert tuple(got.shape) == (2, 3, 6, 3)
    _close(got[1, 2], JV.ambient_cube_integral(jnp.asarray(batch[1, 2])))
    dirs, area = TV.face_solid_angle_weights(16)
    jd, ja = JV.face_solid_angle_weights(16)
    assert np.array_equal(dirs, jd) and np.array_equal(area, ja)


def test_oct_pack_grid_matches():
    amb = _rng().uniform(0.0, 2.0, (6, 2, 3, 4, 3)).astype(np.float32)
    got = TV.oct_pack_grid(torch.as_tensor(amb))
    assert np.array_equal(got.numpy(),
                          np.asarray(JV.oct_pack_grid(jnp.asarray(amb))))


def _volumes(rng):
    """Two overlapping volumes with seeded ambient cubes."""
    out = []
    for res, t, s in (((4, 2, 3), (0.0, 1.0, 0.0), (6.0, 3.0, 5.0)),
                      ((2, 2, 2), (1.5, 0.5, -1.0), (4.0, 4.0, 4.0))):
        node = np.diag([*s, 1.0]).astype(np.float32)
        node[:3, 3] = t
        w2t, t2w = JV.volume_transforms(node)
        amb = rng.uniform(0.0, 2.0, (6, res[2], res[1], res[0], 3)) \
            .astype(np.float32)
        out.append((w2t, t2w, res, amb))
    return out


def test_sample_volumetric_diffuse_matches():
    rng = _rng()
    vols = _volumes(rng)
    jv = [JV.DiffuseVolume(w2t, t2w, res, jnp.asarray(amb),
                           JV.oct_pack_grid(jnp.asarray(amb)))
          for w2t, t2w, res, amb in vols]
    tv = [TV.DiffuseVolume(w2t, t2w, res, torch.as_tensor(amb),
                           TV.oct_pack_grid(torch.as_tensor(amb)))
          for w2t, t2w, res, amb in vols]
    pos = rng.uniform(-5.0, 5.0, (17, 23, 3)).astype(np.float32)
    nrm = rng.normal(size=(17, 23, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    fb = rng.uniform(0.0, 1.0, (6, 3)).astype(np.float32)
    _close(TV.sample_volumetric_diffuse(tv, torch.as_tensor(pos),
                                        torch.as_tensor(nrm),
                                        torch.as_tensor(fb)),
           JV.sample_volumetric_diffuse(jv, jnp.asarray(pos),
                                        jnp.asarray(nrm), jnp.asarray(fb)))
    w2t, t2w = TV.volume_transforms(np.eye(4, dtype=np.float32))
    assert np.array_equal(TV.probe_positions(t2w, (3, 2, 4)),
                          JV.probe_positions(t2w, (3, 2, 4)))


def test_region_fog_density_matches():
    rng = _rng()
    vols = _volumes(rng)
    grid = rng.uniform(0.0, 2.0, (3, 4, 5)).astype(np.float32)
    regions = [(vols[0][0], None), (vols[1][0], grid)]
    pos = rng.uniform(-5.0, 5.0, (6, 7, 9, 3)).astype(np.float32)
    want = JF.region_fog_density(jnp.asarray(pos), regions)
    got = TF.region_fog_density(torch.as_tensor(pos), regions)
    _close(got, want)
    assert 0.0 < float(np.asarray(want).mean()) and \
        float(np.asarray(want).min()) == 0.0


def _apps(cfg, frames: int = 1):
    """The JAX viewer and the port's on the test scene at SIZE, rendered
    `frames` frames -> (jax app, port app, jax image, port image)."""
    from granite_tpu.app.scene_viewer import (
        SceneViewerApplication as JaxViewer,
    )
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    japp = JaxViewer(types.SimpleNamespace(
        scene=None, config=f.name, camera_index=-1, bench_scene=False))
    japp.swapchain_updated(*SIZE)
    app = SceneViewerApplication(types.SimpleNamespace(
        config=f.name, bench_scene=False), device="cpu")
    app.swapchain_updated(*SIZE)
    for i in range(frames):
        ref = np.asarray(japp.render_frame(1 / 60, i / 60))
        japp.post_frame()
        got = app.render_frame(1 / 60, i / 60).numpy()
    return japp, app, ref, got


@pytest.fixture(scope="module")
def diffuse_apps():
    return _apps(DIFFUSE)


def test_baked_ambient_cubes_match(diffuse_apps):
    japp, app, _ref, _got = diffuse_apps
    jv, tv = japp._vol_diffuse, app._vol_diffuse
    assert len(tv["volumes"]) == len(jv["volumes"]) == 1
    j, t = jv["volumes"][0], tv["volumes"][0]
    assert t.resolution == j.resolution
    assert np.array_equal(t.world_to_tex, j.world_to_tex)
    _close(t.ambient, j.ambient, 2e-3)
    _close(t.packed, j.packed, 2e-3)
    _close(tv["fallback"], jv["fallback"])


def test_viewer_diffuse_matches_jax(diffuse_apps):
    _japp, app, ref, got = diffuse_apps
    assert got.shape == ref.shape == (SIZE[1], SIZE[0], 4)
    assert psnr(got, ref) >= GATE_DB
    # the probes light the frame: it differs from the SH ambient's
    lit = app.render_frame(1 / 60, 0.0).numpy()
    volumes, app._vol_diffuse = app._vol_diffuse, None
    sh = app.render_frame(1 / 60, 0.0).numpy()
    app._vol_diffuse = volumes
    assert np.abs(sh.astype(int) - lit.astype(int)).max() > 2


def test_viewer_fog_regions_match_jax():
    japp, app, ref, got = _apps(FOG_REGIONS)
    assert len(app.scene.fog_region_node) == 1
    node = app.scene.fog_region_node[0]
    assert np.array_equal(app.scene.world[node],
                          japp.scene.world[japp.scene.fog_region_node[0]])
    assert psnr(got, ref) >= GATE_DB
