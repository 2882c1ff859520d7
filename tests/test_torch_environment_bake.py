"""The offline environment bake of the port (renderer/environment.py's
prefilter_ggx_equirect, save/load_baked_environment, Environment(baked=),
ops/texture.build_packed_lod_strip_from_levels_np and the two converter
tools) held against the JAX package on seeded inputs, and the slice as a
whole: the viewer's deferred frame with a baked environment against the
JAX viewer's.

Tolerances: the prefiltered chain 1e-5 relative, taken over each level
(max abs difference over the level's max magnitude): the same f32 ops in
the reference's order, the bilinear weights in f64 as numpy promotes
them, but numpy's float32 atan2 and torch's round differently in about a
third of their results (1 ulp), and at a sharp edge (the sun disk's
ramp, a noisy texel) that shift of a bilinear footprint reaches 2.2e-5
of the texel's own value (the default sky at height 32; 5e-7 with
numpy's atan2 in the port) and 4e-6 of the level's magnitude.  The strip
built from one chain 1e-6 (numpy on both sides; measured 0); the
converter tools' .npz 1e-5 as the chain; the frame's luma PSNR >= 48 dB
against the JAX viewer at 128x72 (the golden gate; the baked chain only
changes what the specular fetch reads)."""

import json
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

from golden_utils import CONFIGS, FRAMES, SIZE, TIME_STEP, psnr
from granite_tpu.ops import texture as JT
from granite_tpu.renderer import environment as JE
from granite_tpu_torch.ops import texture as TT
from granite_tpu_torch.renderer import environment as TE

SEED = 17
GATE_DB = 48.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process (several xdist workers share
    the cores; see tests/test_torch_ocean.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_env(h: int) -> np.ndarray:
    """The default sky with seeded noise and single-texel bright
    patches, so the lobes see structure."""
    rng = np.random.default_rng(SEED)
    env = JE.procedural_sky_equirect(h)
    env = env + rng.uniform(0, 0.5, env.shape).astype(np.float32)
    env[rng.integers(0, h, 6), rng.integers(0, 2 * h, 6)] += 20.0
    return env.astype(np.float32)


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("env", ["sky 32", "sky 128", "seeded 16",
                                 "seeded 32"])
def test_prefilter_matches_jax(env):
    kind, height = env.split()
    env = (JE.procedural_sky_equirect(int(height)) if kind == "sky"
           else _seeded_env(int(height)))
    want = JE.prefilter_ggx_equirect(env, 32, 6, samples=16)
    got = TE.prefilter_ggx_equirect(torch.from_numpy(env), 32, 6,
                                    samples=16)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= 1e-5


def test_prefilter_constant_env_is_invariant():
    env = np.full((16, 32, 3), 0.7, np.float32)
    for lv in TE.prefilter_ggx_equirect(env, 16, 4, samples=32):
        assert torch.allclose(lv, torch.full_like(lv, 0.7), atol=1e-3)


def test_strip_from_levels_matches_jax():
    rng = np.random.default_rng(SEED)
    levels = [rng.uniform(0, 4, (32 >> l, 32 >> l, 4)).astype(np.float32)
              for l in range(3)]                # a short chain: 3 of 6
    want = JT.build_packed_lod_strip_from_levels_np(levels)
    got = TT.build_packed_lod_strip_from_levels_np(levels)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_save_load_round_trip_and_baked_environment(tmp_path):
    env = _seeded_env(16)
    t_path, j_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    saved = TE.save_baked_environment(t_path, env, base_size=32, samples=16)
    JE.save_baked_environment(j_path, env, base_size=32, samples=16)
    assert saved["num_levels"] == 6
    for path in (t_path, j_path):
        # each package reads the other's file
        got, want = TE.load_baked_environment(path), \
            JE.load_baked_environment(path)
        assert np.array_equal(got["sh"], want["sh"])
        assert np.array_equal(got["irradiance"], want["irradiance"])
        assert all(np.array_equal(a, b) for a, b in
                   zip(got["reflection"], want["reflection"]))
    t, j = TE.load_baked_environment(t_path), JE.load_baked_environment(
        j_path)
    assert np.array_equal(t["sh"], j["sh"])
    assert _rel(t["irradiance"], j["irradiance"]) <= 1e-5
    for a, b in zip(t["reflection"], j["reflection"]):
        assert _rel(a, b) <= 1e-5
    # Environment(baked=) on the same bake: strips 1e-6, sh equal
    te = TE.Environment(env, baked=j, intensity=1.5)
    je = JE.Environment(env, baked=j, intensity=1.5)
    assert te.num_levels == je.num_levels == 6
    assert np.abs(te.strips.numpy() - np.asarray(je.strips)).max() <= 1e-6
    assert np.array_equal(te.sh.numpy(), np.asarray(je.sh))
    np.savez(str(tmp_path / "bad.npz"), sh=j["sh"])
    with pytest.raises(ValueError):
        TE.load_baked_environment(str(tmp_path / "bad.npz"))


def _tool(name):
    sys.path.insert(0, "tools")
    try:
        return __import__(name)
    finally:
        sys.path.remove("tools")


def _npz_close(a_path, b_path):
    with np.load(a_path) as a, np.load(b_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if a[k].dtype.kind == "f":
                assert _rel(a[k], b[k]) <= 1e-5, k
            else:
                assert np.array_equal(a[k], b[k]), k


def test_equirect_tool_matches_jax(tmp_path, monkeypatch):
    from granite_tpu_torch.tools import convert_equirect_to_environment as T
    src = str(tmp_path / "sky.npy")
    np.save(src, _seeded_env(16))
    args = ["--size", "16", "--samples", "8", "--scale", "1.25"]
    assert T.main([src, "--output", str(tmp_path / "t.npz"), *args,
                   "--irradiance", str(tmp_path / "ti.npy"),
                   "--device", "cpu"]) == 0
    jtool = _tool("convert_equirect_to_environment")
    monkeypatch.setattr(sys, "argv", [
        "x", src, "--output", str(tmp_path / "j.npz"), *args,
        "--irradiance", str(tmp_path / "ji.npy")])
    assert jtool.main() == 0
    _npz_close(str(tmp_path / "t.npz"), str(tmp_path / "j.npz"))
    assert _rel(np.load(tmp_path / "ti.npy"),
                np.load(tmp_path / "ji.npy")) <= 1e-5


def test_cube_tool_matches_jax(tmp_path):
    from granite_tpu_torch.tools import convert_cube_to_environment as T
    rng = np.random.default_rng(SEED)
    faces = []
    for f in range(6):
        path = str(tmp_path / f"face{f}.npy")
        np.save(path, rng.uniform(0, 3, (8, 8, 3)).astype(np.float32))
        faces.append(path)
    args = ["--size", "16", "--samples", "8", "--equirect-height", "16"]
    assert T.main([*faces, "--output", str(tmp_path / "t.npz"), *args,
                   "--device", "cpu"]) == 0
    jtool = _tool("convert_cube_to_environment")
    assert jtool.main([*faces, "--output", str(tmp_path / "j.npz"),
                       *args]) == 0
    _npz_close(str(tmp_path / "t.npz"), str(tmp_path / "j.npz"))


def _render(make_app, env_for, baked):
    """The golden test scene under deferred_hdr at the golden size, the
    viewer's environment rebuilt from its own sky with `baked` (None:
    the default environment) before the graph bake."""
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(CONFIGS["deferred_hdr"], f)
    app = make_app(types.SimpleNamespace(
        scene=None, config=f.name, camera_index=-1, bench_scene=False))
    if baked is not None:
        app.environment = env_for(app, baked)
    app.swapchain_updated(*SIZE)
    out = None
    for i in range(FRAMES):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)


def test_baked_environment_frame_matches_jax_viewer(tmp_path):
    """The slice as a whole: the viewer's own sky baked at base 32 with
    16 samples, loaded, and swapped in as app.environment (sky_params
    kept: the background stays analytic) on both viewers."""
    from granite_tpu.app.scene_viewer import \
        SceneViewerApplication as JApp
    from granite_tpu_torch.app.scene_viewer import \
        SceneViewerApplication as TApp

    def port_app(args):
        return TApp(args, device="cpu")

    def port_env(app, baked):
        sky = app.environment.sky_params
        return TE.Environment(TE.procedural_sky_equirect(128, **sky),
                              sky_params=sky, baked=baked,
                              device=app.device)

    def jax_env(app, baked):
        sky = app.environment.sky_params
        return JE.Environment(JE.procedural_sky_equirect(128, **sky),
                              sky_params=sky, baked=baked)

    probe = port_app(None)
    sky = probe.environment.sky_params
    path = str(tmp_path / "sky.genv.npz")
    TE.save_baked_environment(path, TE.procedural_sky_equirect(128, **sky),
                              base_size=32, samples=16)
    baked = TE.load_baked_environment(path)
    got = _render(port_app, port_env, baked)
    want = _render(JApp, jax_env, baked)
    assert psnr(got, want) >= GATE_DB
    # the baked chain is what the frame read: the default environment's
    # frame differs
    default = _render(port_app, port_env, None)
    assert (got != default).any()
