"""The port's animation system (scene/animation.py) and the viewer's
per-frame skin palette and morph weights held against the JAX package on
channels and times made from a numpy seed, and the viewer's animated
frames (render_frame and render_frames_chained agree).

Tolerance: 1e-6 absolute on every sampled value, pose and matrix (the
copies run the same numpy code, so they agree to the last bit in
practice)."""

import json
import types

import numpy as np
import pytest
import torch

import gltf_fixtures as GF
from granite_tpu.app.scene_viewer import SceneViewerApplication as JaxViewer
from granite_tpu.math.muglm import quat_slerp as jax_slerp
from granite_tpu.scene import animation as JA
from granite_tpu.scene import scene as JS
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.math.muglm import quat_slerp
from granite_tpu_torch.scene import animation as TA
from granite_tpu_torch.scene import scene as TS
from granite_tpu_torch.scene.gltf import GLTFParser

TOL = 1e-6
SEED = 5
TIME_STEP = 1.0 / 60.0


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


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("animation")
    GF.write_character(str(d / "character.gltf"))
    GF.write_morph_sheet(str(d / "morph.gltf"))
    with open(d / "anim.scene", "w") as f:
        json.dump({"scenes": [
            {"path": "character.gltf",
             "instances": [{"translation": [0.0, 1.0, 0.0]}]},
            {"path": "morph.gltf"}]}, f)
    with open(d / "cfg.json", "w") as f:
        json.dump({"renderer": "deferred", "hdrBloom": False,
                   "shadowMapResolution": 32,
                   "clusteredLightsShadows": False}, f)
    return d


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max(initial=0.0)) <= TOL


def _channel(rng, path, interp, comps):
    k = int(rng.integers(2, 7))
    times = np.sort(rng.uniform(0.0, 3.0, k)).astype(np.float32)
    shape = (k, 3, comps) if interp == "CUBICSPLINE" else (k, comps)
    values = rng.normal(size=shape).astype(np.float32)
    return dict(node=0, path=path, interp=interp, times=times, values=values)


@pytest.mark.parametrize("path,interp,comps", [
    ("translation", "LINEAR", 3), ("rotation", "LINEAR", 4),
    ("scale", "STEP", 3), ("rotation", "STEP", 4),
    ("translation", "CUBICSPLINE", 3), ("rotation", "CUBICSPLINE", 4),
    ("weights", "LINEAR", 4), ("weights", "CUBICSPLINE", 4)])
def test_sample_channel_matches_jax(path, interp, comps):
    rng = np.random.default_rng(SEED)
    for _ in range(6):
        ch = _channel(rng, path, interp, comps)
        # before, inside and past the keys, and on them
        ts = list(rng.uniform(-1.0, 4.0, 16)) + list(ch["times"])
        for t in ts:
            _close(TA._sample_channel(ch, float(t)),
                   JA._sample_channel(ch, float(t)))
    one = dict(_channel(rng, path, interp, comps))
    one["times"], one["values"] = one["times"][:1], one["values"][:1]
    _close(TA._sample_channel(one, 1.0), JA._sample_channel(one, 1.0))
    empty = dict(one, times=one["times"][:0])
    assert TA._sample_channel(empty, 1.0) is None


def test_quat_slerp_matches_jax():
    rng = np.random.default_rng(SEED)
    for _ in range(64):
        a, b = rng.normal(size=(2, 4)).astype(np.float32)
        a /= np.linalg.norm(a)
        b = a + 0.01 * b if rng.uniform() < 0.3 else b / np.linalg.norm(b)
        t = float(rng.uniform())
        _close(quat_slerp(a, b, t), jax_slerp(a, b, t))


@pytest.mark.parametrize("looping", [True, False])
def test_animation_system_matches_jax(files, looping):
    """The character's and the sheet's animations played onto both Scene
    classes at seeded times: every node's TRS and the morph weights."""
    infos = [GLTFParser(str(files / n)).get_scene()
             for n in ("character.gltf", "morph.gltf")]
    rng = np.random.default_rng(SEED)
    scenes = TS.Scene(), JS.Scene()
    systems = TA.AnimationSystem(scenes[0]), JA.AnimationSystem(scenes[1])
    for sc in scenes:
        for _ in range(len(infos[0].nodes)):
            sc.create_node()
    for system in systems:
        for info in infos:
            for anim in info.animations:
                system.start_animation(anim, start_time=0.25,
                                       looping=looping)
    paused = systems[0].start_animation(infos[0].animations[0])
    paused.playing = False
    systems[0].stop_animation(paused)
    assert len(systems[0].states) == len(systems[1].states) == 2
    for t in list(rng.uniform(-1.0, 7.0, 24)) + [0.25, 2.25]:
        for system in systems:
            system.animate(float(t))
        a, b = scenes
        n = a.num_nodes
        for k in ("translation", "rotation", "scale"):
            _close(getattr(a, k)[:n], getattr(b, k)[:n])
        assert a.node_morph_weights.keys() == b.node_morph_weights.keys()
        for node, w in a.node_morph_weights.items():
            _close(w, b.node_morph_weights[node])


def test_palette_and_morph_weights_match_jax(files):
    """The viewer's per-frame skin palette and morph weights at seeded
    times, against the JAX viewer's methods on the same poses."""
    app = SceneViewerApplication(types.SimpleNamespace(
        config=str(files / "cfg.json"), bench_scene=False,
        scene=str(files / "anim.scene"), camera_index=-1), device="cpu")
    jax_self = types.SimpleNamespace(info=app.info, scene=app.scene,
                                     packed=app.packed)
    rng = np.random.default_rng(SEED)
    for t in rng.uniform(0.0, 4.0, 4):
        app.animation_system.animate(float(t))
        app.scene.update_transform_tree()
        _close(app._skin_palette().numpy(),
               JaxViewer._skin_palette(jax_self))
        _close(app._morph_weights().numpy(),
               JaxViewer._morph_weights(jax_self))
    assert app._morph_weights().abs().sum() > 0


def test_chained_frames_match_render_frame(files):
    """An animated scene chained (orbiting) equals the same frames through
    render_frame, posed at t0 + i * frame_time with the camera yawed
    i * orbit, and the animation moves the frame."""
    def app():
        a = SceneViewerApplication(types.SimpleNamespace(
            config=str(files / "cfg.json"), bench_scene=False,
            scene=str(files / "anim.scene"), camera_index=-1), device="cpu")
        a.swapchain_updated(48, 32)
        return a

    t0, orbit, n = 0.4, 0.05, 3
    chained = app().render_frames_chained(TIME_STEP, t0, n,
                                          camera_orbit=orbit).numpy()
    seq = app()
    pos, rot = seq.camera.position.copy(), seq.camera.rotation.copy()
    out = None
    for i in seq._orbit(n, orbit):
        out = seq.render_frame(TIME_STEP, t0 + i * TIME_STEP).numpy()
    assert np.array_equal(chained, out)
    assert np.array_equal(seq.camera.position, pos)
    assert np.array_equal(seq.camera.rotation, rot)
    still = app()
    a = still.render_frame(TIME_STEP, 0.0).numpy()
    b = still.render_frame(TIME_STEP, 0.9).numpy()
    assert np.abs(a.astype(int) - b).max() > 8


@pytest.mark.parametrize("vsm", [False, True])
def test_dynamic_casters_join_the_sun_map(files, vsm):
    """The shadow pass composites the posed skinned casters onto the
    cached static map every frame (and under VSM blurs the composite's
    moments every frame): the static map stays, the pass's output
    follows the animation."""
    from granite_tpu_torch.ops.shadow import vsm_moments
    from granite_tpu_torch.renderer.scene_renderer import render_shadow_map
    cfg = files / f"vsm_{vsm}.json"
    cfg.write_text(json.dumps({
        "renderer": "deferred", "hdrBloom": False, "shadowMapResolution": 64,
        "clusteredLightsShadows": False,
        "directionalLightShadowsVSM": vsm}))
    app = SceneViewerApplication(types.SimpleNamespace(
        config=str(cfg), bench_scene=False, scene=str(files / "anim.scene"),
        camera_index=-1), device="cpu")
    app.swapchain_updated(48, 32)
    outs, statics = [], []
    for t in (0.0, 0.9):
        app.animation_system.animate(t)
        p = app.build_frame_params(TIME_STEP, t)
        ctx = types.SimpleNamespace(params=p,
                                    input=lambda n, p=p: p["external"][n])
        outs.append(app._shadow_pass(ctx)["shadow-depth"])
        statics.append(p["static_shadow_depth"])
        dyn = render_shadow_map(
            app.packed, p["external"]["world"], p["shadow_vp"], 64,
            p["dynamic_shadow_mask"], p["skin_palette"], p["morph_weights"])
        want = torch.maximum(p["static_shadow_depth"], dyn)
        assert torch.equal(outs[-1], vsm_moments(want) if vsm else want)
    assert statics[0] is statics[1]
    assert outs[0].shape[-1:] == ((2,) if vsm else (64,))
    assert not torch.equal(outs[0], outs[1])
