"""The port's volumetric decals (ops/decals, the quad-packed strip builder
and its clamp-addressed sampler in ops/texture) held against the JAX
package on inputs made from a numpy seed, and the deferred_decals golden
config rendered end to end on the CPU, with and without a decal node.

Tolerances: the numpy builders and the decal table byte-equal; the
sampler and the blend within 1e-5 (XLA's CPU contractions round
differently from torch); renders at the 48 dB luma gate."""

import json
import os
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import CONFIGS, FRAMES, GOLDEN_DIR, SIZE, TIME_STEP, psnr
from granite_tpu.ops import decals as JD
from granite_tpu.ops import texture as JT
from granite_tpu.utils.image_io import load_image
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.ops import decals as TD
from granite_tpu_torch.ops import texture as TT

GATE_DB = 48.0
SEED = 11


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


def _images(rng, n=3, size=16):
    """RGBA decal images with alpha in [0, 1]."""
    return [rng.uniform(0.0, 1.0, (size, size, 4)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("wrap", [TT.WRAP_REPEAT, TT.WRAP_CLAMP])
def test_packed_strip_and_level_sampler(wrap):
    rng = _rng()
    img = rng.normal(size=(16, 16, 4)).astype(np.float32)
    for dtype in ("float32", "float16"):
        got = TT.build_packed_strip_np(img, wrap, dtype)
        want = JT.build_packed_strip_np(img, wrap, dtype)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    strips = np.stack([TT.build_packed_strip_np(i, wrap, "float32")
                       for i in _images(rng)])
    n = 600
    # inside, past the edges, and past the int32 range once scaled
    u = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    u[:8] = [3e9, -3e9, 7e8, 1e8, 0.0, 1.0, 0.999, 1e-6]
    tid = rng.integers(0, 3, n).astype(np.int32)
    lvl = rng.integers(-1, 7, n).astype(np.int32)
    got = TT.sample_packed_level(torch.as_tensor(strips),
                                 torch.as_tensor(tid), torch.as_tensor(u),
                                 torch.as_tensor(v), torch.as_tensor(lvl), 4,
                                 wrap)
    want = JT.sample_packed_level(jnp.asarray(strips), jnp.asarray(tid),
                                  jnp.asarray(u), jnp.asarray(v),
                                  jnp.asarray(lvl), 4, wrap)
    _close(got, want, 1e-5)


def _translate_scale(t, s, angle=0.0):
    c, s_ = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot * np.asarray(s, np.float32)
    m[:3, 3] = t
    return m


# name -> (decal transforms, tex ids, capacity): two overlapping boxes and
# a disjoint one; a table with no live decal (every slot dead); boxes whose
# uvw reach the clamp edge of the texture; a rotated, three-deep stack
# (deeper than the two layers, where only the layered paths agree).
CASES = {
    "overlap": ([_translate_scale((0, 0, 0), (2, 2, 2)),
                 _translate_scale((0.5, 0, 0), (2, 2, 2)),
                 _translate_scale((5, 5, 5), (1, 1, 1))], [0, 1, 2], 8),
    "dead": ([], [], 4),
    "clamped_edge": ([_translate_scale((0.0, 0.0, 0.0), (8, 8, 8)),
                      _translate_scale((2.0, 1.0, 0.0), (4, 6, 4))],
                     [2, 0], 4),
    "three_deep": ([_translate_scale((0, 0, 0), (3, 3, 3), 0.4),
                    _translate_scale((0.3, 0, 0.2), (3, 3, 3), -0.7),
                    _translate_scale((-0.2, 0.1, 0), (3, 3, 3), 1.1)],
                   [1, 2, 0], 16),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_decals_matches_jax(name):
    rng = _rng()
    transforms, tex_ids, cap = CASES[name]
    strips = TD.build_decal_strips(_images(rng))
    want_strips = JD.build_decal_strips(_images(_rng()))
    assert strips.tobytes() == want_strips.tobytes()
    got_d = TD.pack_decals(transforms, tex_ids, capacity=cap)
    want_d = JD.pack_decals(transforms, tex_ids, capacity=cap)
    for a, b in zip(got_d, want_d):
        assert np.array_equal(a.numpy(), np.asarray(b))
    pos = rng.uniform(-4.5, 6.0, (24, 20, 3)).astype(np.float32)
    if name == "clamped_edge":
        # pixels on the decal's faces: uvw at +-0.5 -> the texture edge
        pos[:4, :, 0] = rng.choice([-3.999, 3.999], (4, 20))
    base = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    alpha = rng.uniform(size=(24, 20)).astype(np.float32)
    t_args = (torch.as_tensor(base), torch.as_tensor(alpha),
              torch.as_tensor(pos), got_d, torch.as_tensor(strips))
    j_args = (jnp.asarray(base), jnp.asarray(alpha), jnp.asarray(pos),
              want_d, jnp.asarray(want_strips))
    got = TD.apply_decals(*t_args, layers=2)
    for g, w in zip(got, JD.apply_decals(*j_args, layers=2)):
        _close(g, w, 1e-5)
    ref = TD.apply_decals_reference(*t_args)
    for g, w in zip(ref, JD.apply_decals_reference(*j_args)):
        _close(g, w, 1e-5)
    # the layered path reproduces the sequential mix where at most two
    # decals cover a pixel
    uvw = np.einsum("hwj,dij->hwdi",
                    np.concatenate([pos, np.ones_like(pos[..., :1])], -1),
                    got_d.world_to_tex.numpy())
    live = np.arange(cap) < int(got_d.count)
    depth = ((np.abs(uvw) < 0.5).all(-1) & live).sum(-1)
    shallow = depth <= 2
    assert shallow.any()
    if name == "three_deep":
        assert (depth == 3).any()
    if name == "dead":
        assert not depth.any()
        _close(got[0], base, 0.0)
    for g, r in zip(got, ref):
        _close(g[torch.as_tensor(shallow)], r[torch.as_tensor(shallow)],
               1e-5)


def test_decal_helpers_match_jax():
    rng = _rng()
    for size in (8, 128):
        got = TD.builtin_decal_image(size)
        want = JD.builtin_decal_image(size)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    ms = [_translate_scale(rng.normal(size=3), rng.uniform(0.5, 3, 3),
                           float(rng.uniform(-3, 3))) for _ in range(5)]
    for a, b in zip(TD.decal_world_aabbs(ms), JD.decal_world_aabbs(ms)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The golden config end to end
# ---------------------------------------------------------------------------

def _app(cfg, decal: bool):
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    try:
        app = SceneViewerApplication(types.SimpleNamespace(
            config=f.name, bench_scene=False), device="cpu")
    finally:
        os.unlink(f.name)
    if decal:
        _add_decal(app.scene)
    return app


def _add_decal(scene):
    """One decal box over the test scene's floor, as tests/test_decals.py
    places it."""
    node = scene.create_node(translation=(0, 0, 0), scale=(6, 6, 6))
    scene.create_volumetric_decal(node, 0)
    scene.update_transform_tree()


def _render(cfg, decal=False):
    app = _app(cfg, decal)
    app.swapchain_updated(*SIZE)
    out = None
    for i in range(FRAMES):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
    return out.numpy(), app


def test_decals_golden_png():
    """deferred_decals has no decal node, so its golden is the plain
    frame: the decal pass is not in the frame and changes nothing."""
    got, app = _render(CONFIGS["deferred_decals"])
    assert not app._has_decals
    golden = load_image(os.path.join(GOLDEN_DIR, "deferred_decals.png"))
    assert got.shape == golden.shape
    assert psnr(got, golden) >= GATE_DB


def test_decal_node_render_matches_jax():
    """deferred_decals with one decal node: the port against the JAX
    render with the same node, and the decal visibly changes the frame."""
    from granite_tpu.app.scene_viewer import \
        SceneViewerApplication as JaxViewer
    cfg = CONFIGS["deferred_decals"]
    got, app = _render(cfg, decal=True)
    assert app._has_decals
    assert int(app._param_cache[1]["decals"].count) == 1
    # the JAX viewer watches its config file while it renders
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        japp = JaxViewer(types.SimpleNamespace(
            scene=None, config=path, camera_index=-1, bench_scene=False))
        _add_decal(japp.scene)
        japp.swapchain_updated(*SIZE)
        for i in range(FRAMES):
            want = japp.render_frame(TIME_STEP, i * TIME_STEP)
            japp.post_frame()
        want = np.asarray(want)
    assert got.shape == want.shape == (SIZE[1], SIZE[0], 4)
    assert psnr(got, want) >= GATE_DB
    plain, _ = _render(cfg)
    diff = np.abs(got[..., :3].astype(int) - plain[..., :3]).max(-1)
    assert int((diff > 8).sum()) > 20
