"""The port's copies of the JAX package's host modules (math/, scene/,
utils/) held equal to their originals on inputs made from a numpy seed.
The copies are the same numpy code, so every comparison is exact."""

import os
from dataclasses import fields

import numpy as np
import pytest

from granite_tpu.app.bench_scene import build_bench_scene as jax_bench
from granite_tpu.math import frustum as JF
from granite_tpu.math import muglm as JM
from granite_tpu.math.aabb import transform_aabbs as jax_transform_aabbs
from granite_tpu.math.transforms import compose_trs_batch as jax_compose
from granite_tpu.scene import mesh_util as JMU
from granite_tpu.scene import scene as JS
from granite_tpu.scene.camera import FPSCamera as JaxCamera
from granite_tpu.scene.scene_formats import (
    generate_normals as jax_normals, generate_tangents as jax_tangents,
)
from granite_tpu.utils.image_io import load_image as jax_load_image
from granite_tpu.math.transforms import decompose_trs as jax_decompose
from granite_tpu.scene import scene_formats as JSF
from granite_tpu.scene_export import camera_export as JCE
from granite_tpu.utils import image_compare as JIC
from granite_tpu.utils.timer import FrameTimer as JaxFrameTimer
from granite_tpu.app import video_sink as JVS
from granite_tpu.utils import hashing as JH
from granite_tpu_torch.app import bench_scene as TB
from granite_tpu_torch.math import frustum as TF
from granite_tpu_torch.math import muglm as TM
from granite_tpu_torch.math.aabb import transform_aabbs
from granite_tpu_torch.math.transforms import compose_trs_batch
from granite_tpu_torch.scene import mesh_util as TMU
from granite_tpu_torch.scene import scene as TS
from granite_tpu_torch.scene import scene_formats as TSF
from granite_tpu_torch.scene.camera import FPSCamera
from granite_tpu_torch.utils.image_io import load_image, save_png
from granite_tpu_torch.app import video_sink as TVS
from granite_tpu_torch import utils as TU
from granite_tpu_torch.utils import hashing as TH
from granite_tpu_torch.math.transforms import decompose_trs
from granite_tpu_torch.scene_export import camera_export as TCE
from granite_tpu_torch.utils import image_compare as TIC
from granite_tpu_torch.utils.timer import FrameTimer
from test_torch_ecs import scene_entities

RNG_SEED = 4


def _rng():
    return np.random.default_rng(RNG_SEED)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


def _quat(rng):
    return rng.normal(size=4).astype(np.float32)


@pytest.mark.parametrize("name", ["perspective_inf", "perspective_far",
                                  "ortho", "look_at_matrix", "translate"])
def test_muglm_matrices(name):
    rng = _rng()
    for _ in range(8):
        fovy, aspect = rng.uniform(0.3, 2.0), rng.uniform(0.5, 3.0)
        zn = rng.uniform(0.01, 1.0)
        eye, at = rng.normal(size=3), rng.normal(size=3) * 4
        lo = rng.uniform(-5, -1, size=3)
        hi = rng.uniform(1, 5, size=3)
        args = {"perspective_inf": ("perspective", (fovy, aspect, zn)),
                "perspective_far": ("perspective", (fovy, aspect, zn, 100.0)),
                "ortho": ("ortho", (lo[0], hi[0], lo[1], hi[1], 0.5, hi[2])),
                "look_at_matrix": ("look_at_matrix", (eye, at, (0, 1, 0))),
                "translate": ("translate", (eye,))}[name]
        fn, a = args
        _eq(getattr(TM, fn)(*a), getattr(JM, fn)(*a))


@pytest.mark.parametrize("name", ["from_axis_angle", "mul", "normalize",
                                  "rotate", "mat3_cast", "mat4_cast",
                                  "look_at_quat", "from_mat3"])
def test_muglm_quaternions(name):
    rng = _rng()
    for _ in range(16):
        q, r = _quat(rng), _quat(rng)
        v = rng.normal(size=3).astype(np.float32)
        if name == "from_axis_angle":
            a = (v, float(rng.uniform(-7, 7)))
            fn = "quat_from_axis_angle"
        elif name == "mul":
            a, fn = (q, r), "quat_mul"
        elif name == "normalize":
            a, fn = (q,), "quat_normalize"
        elif name == "rotate":
            a, fn = (q, v), "quat_rotate"
        elif name == "look_at_quat":
            a, fn = (v, (0.0, 1.0, 0.0)), "look_at_quat"
        elif name == "from_mat3":
            # every branch: trace > 0 and each largest-diagonal case
            a, fn = (JM.mat3_cast(q),), "_quat_from_mat3"
        else:
            a, fn = (q,), name
        _eq(getattr(TM, fn)(*a), getattr(JM, fn)(*a))


def test_frustum_planes_and_culling():
    rng = _rng()
    for _ in range(4):
        vp = (JM.perspective(rng.uniform(0.5, 1.5), 16 / 9, 0.1)
              @ JM.look_at_matrix(rng.normal(size=3), rng.normal(size=3) * 5,
                                  (0, 1, 0))).astype(np.float32)
        _eq(TF.extract_planes(vp), JF.extract_planes(vp))
        _eq(TF.Frustum(vp).planes, JF.Frustum(vp).planes)
        c = rng.normal(size=(200, 3)).astype(np.float32) * 20
        e = rng.uniform(0.1, 3, size=(200, 3)).astype(np.float32)
        got = TF.frustum_cull(TF.extract_planes(vp), c - e, c + e)
        want = JF.frustum_cull(JF.extract_planes(vp), c - e, c + e)
        _eq(got, want)
        assert 0 < int(got.sum()) < 200


def test_aabb_and_trs():
    rng = _rng()
    n = 50
    t = rng.normal(size=(n, 3)).astype(np.float32)
    r = rng.normal(size=(n, 4)).astype(np.float32)
    s = rng.uniform(0.2, 3, size=(n, 3)).astype(np.float32)
    _eq(compose_trs_batch(t, r, s), jax_compose(t, r, s))
    w = jax_compose(t, r, s)
    mn = rng.normal(size=(n, 3)).astype(np.float32)
    mx = mn + rng.uniform(0, 2, size=(n, 3)).astype(np.float32)
    for got, want in zip(transform_aabbs(w, mn, mx),
                         jax_transform_aabbs(w, mn, mx)):
        _eq(got, want)


@pytest.mark.parametrize("ortho", [False, True])
def test_fps_camera_view_and_projection(ortho):
    rng = _rng()
    for zfar in (0.0, 500.0):
        cams = FPSCamera(), JaxCamera()
        eye, at = rng.normal(size=3) * 3, rng.normal(size=3)
        for cam in cams:
            cam.look_at(eye, at)
            cam.set_depth_range(0.05, zfar)
            cam.set_aspect(1.7)
            cam.set_fovy(0.8)
            if ortho:
                cam.set_ortho(True, 3.0, 2.0)
        _eq(cams[0].position, cams[1].position)
        _eq(cams[0].rotation, cams[1].rotation)
        _eq(cams[0].get_view(), cams[1].get_view())
        _eq(cams[0].get_projection(), cams[1].get_projection())
        assert (cams[0].fovy, cams[0].aspect, cams[0].znear, cams[0].zfar) \
            == (cams[1].fovy, cams[1].aspect, cams[1].znear, cams[1].zfar)


def test_fps_camera_fly_controls():
    """move and rotate on seeded steps, speeds and time steps: position
    and rotation within 1e-6 of the original's after every call."""
    rng = _rng()
    cams = FPSCamera(), JaxCamera()
    eye, at = rng.normal(size=3) * 3, rng.normal(size=3)
    speed, turn = rng.uniform(0.5, 5.0, size=2)
    for cam in cams:
        cam.look_at(eye, at)
        cam.speed, cam.turn_speed = float(speed), float(turn)
    for _ in range(40):
        f, r, u, yaw, pitch = rng.uniform(-1.0, 1.0, size=5)
        dt = float(rng.uniform(0.0, 0.1))
        for cam in cams:
            cam.move(f, r, u, dt)
            cam.rotate(yaw, pitch, dt)
        for name in ("position", "rotation"):
            got, want = getattr(cams[0], name), getattr(cams[1], name)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for a, b in ((cams[0].get_right(), cams[1].get_right()),
                 (cams[0].get_up(), cams[1].get_up())):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_hashing_known_vectors_and_streams():
    """FNV-1a's published 64-bit vectors, then seeded streams of bytes,
    strings, ints (negative ones wrap) and Hasher calls: the same hashes
    as the original's, exactly; the package exports them as the JAX
    package's utils does."""
    assert TU.fnv1a is TH.fnv1a and TU.Hasher is TH.Hasher
    assert TU.hash_combine is TH.hash_combine
    assert TH.fnv1a(b"") == 0xCBF29CE484222325
    assert TH.fnv1a(b"a") == 0xAF63DC4C8601EC8C
    assert TH.fnv1a("foobar") == 0x85944171F73967E8
    rng = _rng()
    for _ in range(50):
        data = rng.integers(0, 256, size=int(rng.integers(0, 64)),
                            dtype=np.uint8).tobytes()
        text = "".join(chr(int(c)) for c in rng.integers(32, 0x3000,
                                                         size=8))
        n = int(rng.integers(-2 ** 63, 2 ** 63))
        seed = int(rng.integers(0, 2 ** 63))
        for value in (data, text, n):
            assert TH.fnv1a(value) == JH.fnv1a(value)
            assert TH.hash_combine(seed, value) == \
                JH.hash_combine(seed, value)
        f = float(rng.normal())
        u = int(rng.integers(0, 2 ** 63)) * 3
        got, want = TH.Hasher(seed), JH.Hasher(seed)
        for h in (got, want):
            h.data(data).u32(u).u64(-u).f32(f).string(text)
        assert got.get() == want.get()


def _same_mesh(a, b):
    """b, the port's MeshData, equals a in every field it keeps; the
    fields it left out hold their defaults in a."""
    assert type(a).__name__ == type(b).__name__ == "MeshData"
    kept = {f.name for f in fields(b)}
    for f in fields(a):
        x = getattr(a, f.name)
        if f.name not in kept:
            assert x == f.default, f.name    # None, "classic" or 0
            continue
        y = getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            _eq(x, y)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name,args", [
    ("cube_mesh", (3,)), ("sphere_mesh", (7, 2)), ("plane_mesh", (1, 5.0)),
    ("cylinder_mesh", (9, 0))])
def test_mesh_util_builders(name, args):
    _same_mesh(getattr(JMU, name)(*args), getattr(TMU, name)(*args))


def test_normals_and_tangents():
    rng = _rng()
    pos = rng.normal(size=(40, 3)).astype(np.float32)
    idx = rng.integers(0, 40, size=(60, 3)).astype(np.int32)
    uv = rng.uniform(size=(40, 2)).astype(np.float32)
    uv[:5] = 0.0                       # degenerate UVs: fallback tangents
    n = jax_normals(pos, idx)
    _eq(TSF.generate_normals(pos, idx), n)
    _eq(TSF.generate_tangents(pos, n, uv, idx), jax_tangents(pos, n, uv, idx))


def test_decompose_trs():
    """Scaled rotations, a mirrored one among them (det < 0)."""
    rng = _rng()
    for i in range(16):
        s = rng.uniform(0.2, 3, size=3).astype(np.float32)
        if i % 4 == 0:
            s[1] = -s[1]
        m = jax_compose(rng.normal(size=(1, 3)).astype(np.float32),
                        _quat(rng)[None], s[None])[0]
        for got, want in zip(decompose_trs(m), jax_decompose(m)):
            _eq(got, want)


@pytest.mark.parametrize("name", ["CameraData", "AnimationData", "SkinData",
                                  "NodeData", "MaterialData", "SceneInfo"])
def test_scene_records_match(name):
    """The records the glTF parser fills: the same fields, in the same
    order, with the same defaults."""
    a, b = getattr(TSF, name)(), getattr(JSF, name)()
    assert [f.name for f in fields(a)] == [f.name for f in fields(b)]
    for f in fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            _eq(x, y)
        else:
            assert x == y, f.name
    if name == "AnimationData":
        ch = [dict(times=np.array([0.0, 1.5], np.float32)),
              dict(times=np.array([], np.float32))]
        assert TSF.AnimationData(channels=ch).duration == \
            JSF.AnimationData(channels=ch).duration == 1.5


def test_frame_timer_fixed_steps():
    timers = FrameTimer(), JaxFrameTimer()
    for step in (0.016, 1 / 60, 0.1, 0.03):
        got = [t.frame(fixed_step=step) for t in timers]
        assert got[0] == got[1] == step
        assert timers[0].get_elapsed() == timers[1].get_elapsed()
        assert timers[0].get_frame_time() == timers[1].get_frame_time()
    assert FrameTimer().frame() >= 0.0       # the wall clock's period


def test_image_compare():
    rng = _rng()
    a = rng.integers(0, 256, size=(9, 13, 4)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-3, 4, size=a.shape), 0,
                255).astype(np.uint8)
    for x, y in ((a, b), (a, a)):
        assert TIC.psnr_channels(x, y) == JIC.psnr_channels(x, y)
        _eq(TIC.diff_image(x, y), JIC.diff_image(x, y))


def test_camera_export_round_trip():
    rng = _rng()
    cams = [TCE.RecordedCamera(fovy=float(rng.uniform(0.5, 1.5)),
                               position=rng.normal(size=3).astype(np.float32),
                               direction=rng.normal(size=3).astype(
                                   np.float32)) for _ in range(3)]
    text = TCE.export_cameras_to_json(cams)
    assert text == JCE.export_cameras_to_json(cams)
    for got, want in zip(TCE.import_cameras_from_json(text),
                         JCE.import_cameras_from_json(text)):
        for f in fields(want):
            if isinstance(getattr(want, f.name), np.ndarray):
                _eq(getattr(got, f.name), getattr(want, f.name))
            else:
                assert getattr(got, f.name) == getattr(want, f.name)


def test_video_sink_png_sequence(tmp_path, monkeypatch):
    """Without ffmpeg both sinks write the same numbered PNG files."""
    rng = _rng()
    frames = rng.integers(0, 256, size=(3, 6, 8, 4)).astype(np.uint8)
    for mod, name in ((TVS, "port"), (JVS, "jax")):
        monkeypatch.setattr(mod.shutil, "which", lambda _name: None)
        sink = mod.VideoSink(str(tmp_path / f"{name}.mp4"), 8, 6)
        for f in frames:
            sink.push_frame(f)
        sink.close()
    got = sorted(os.listdir(tmp_path / "port_frames"))
    assert got == sorted(os.listdir(tmp_path / "jax_frames")) == [
        f"frame_{i:05d}.png" for i in range(3)]
    for n in got:
        _eq(load_image(str(tmp_path / "port_frames" / n)),
            load_image(str(tmp_path / "jax_frames" / n)))


def test_scene_flags_and_constants():
    for k in ("RENDERABLE_OPAQUE", "RENDERABLE_TRANSPARENT",
              "RENDERABLE_CASTS_SHADOW", "RENDERABLE_DYNAMIC"):
        assert getattr(TS, k) == getattr(JS, k), k
    from granite_tpu.scene import scene_formats as JSF
    for k in ("ALPHA_MODE_OPAQUE", "ALPHA_MODE_MASK", "ALPHA_MODE_BLEND",
              "LIGHT_DIRECTIONAL", "LIGHT_POINT", "LIGHT_SPOT"):
        assert getattr(TSF, k) == getattr(JSF, k), k


def test_scene_transforms_and_gathers():
    """The same node tree (more nodes than the initial capacity, so both
    grow), renderables and frusta through both Scene classes."""
    rng = _rng()
    scenes = TS.Scene(), JS.Scene()
    for i in range(90):
        parent = int(rng.integers(-1, i)) if i else -1
        t = rng.normal(size=3) * 4
        r = _quat(rng)
        s = rng.uniform(0.5, 2, size=3)
        for sc in scenes:
            sc.create_node(parent=parent, translation=t, rotation=r, scale=s)
    for i in range(70):
        flags = int(rng.integers(1, 16))
        mn = rng.normal(size=3)
        mx = mn + rng.uniform(0.1, 2, size=3)
        node = int(rng.integers(0, 90))
        for sc in scenes:
            sc.add_renderable(node, i, flags, mn, mx)
    for sc in scenes:
        sc.update_transform_tree()
    a, b = scenes
    assert a.num_nodes == b.num_nodes == 90
    _eq(a.world[:90], b.world[:90])
    for k in ("r_node", "r_mesh", "r_flags", "r_world_min", "r_world_max"):
        _eq(getattr(a, k), getattr(b, k))
    for _ in range(3):
        vp = (JM.perspective(1.0, 1.5, 0.1)
              @ JM.look_at_matrix(rng.normal(size=3) * 10, np.zeros(3),
                                  (0, 1, 0))).astype(np.float32)
        fa, fb = TF.Frustum(vp), JF.Frustum(vp)
        for q in ("gather_visible_opaque_renderables",
                  "gather_visible_transparent_renderables",
                  "gather_visible_static_shadow_renderables",
                  "gather_visible_dynamic_shadow_renderables"):
            _eq(getattr(a, q)(fa), getattr(b, q)(fb))
    # a re-parented node moves with its new parent in both
    for sc in scenes:
        sc.set_parent(5, 80)
        sc.update_transform_tree()
    _eq(a.world[:90], b.world[:90])
    assert a.node_morph_weights == b.node_morph_weights == {}
    # the entity half: an entity a node, then one a renderable
    assert scene_entities(a) == scene_entities(b)
    assert len(a.entity_pool) == 90 + 70


def test_scene_volumetric_decals():
    """The decal half of Scene: create_volumetric_decal on nodes of both
    Scene classes, then the frustum gather of the unit boxes."""
    rng = _rng()
    scenes = TS.Scene(), JS.Scene()
    for i in range(24):
        t = rng.normal(size=3) * 12
        r = _quat(rng)
        s = rng.uniform(0.3, 4, size=3)
        for sc in scenes:
            sc.create_node(parent=-1, translation=t, rotation=r, scale=s)
    nodes = rng.permutation(24)[:16]
    for k, node in enumerate(nodes):
        idx = [sc.create_volumetric_decal(int(node), k % 3) for sc in scenes]
        assert idx == [k, k]
    for sc in scenes:
        sc.update_transform_tree()
    a, b = scenes
    assert a.decal_node == b.decal_node and a.decal_tex == b.decal_tex
    assert [e.get_component(TS.VolumetricDecalComponent).index
            for e in a.decal_entity] == list(range(16))
    assert [e.get_component(TS.TransformComponent).node
            for e in a.decal_entity] == [int(n) for n in nodes]
    assert scene_entities(a) == scene_entities(b)
    empty = TS.Scene(), JS.Scene()
    for _ in range(4):
        vp = (JM.perspective(1.0, 1.5, 0.1)
              @ JM.look_at_matrix(rng.normal(size=3) * 10, np.zeros(3),
                                  (0, 1, 0))).astype(np.float32)
        got = a.gather_visible_volumetric_decals(TF.Frustum(vp))
        _eq(got, b.gather_visible_volumetric_decals(JF.Frustum(vp)))
        _eq(empty[0].gather_visible_volumetric_decals(TF.Frustum(vp)),
            empty[1].gather_visible_volumetric_decals(JF.Frustum(vp)))


def test_scene_fog_regions_and_diffuse_volumes():
    """create_volumetric_fog_region (with and without a density grid) and
    create_volumetric_diffuse_light on nodes of both Scene classes."""
    rng = _rng()
    scenes = TS.Scene(), JS.Scene()
    for _ in range(6):
        t = rng.normal(size=3) * 12
        s = rng.uniform(0.3, 40, size=3)
        for sc in scenes:
            sc.create_node(translation=t, scale=s)
    grid = rng.uniform(0, 2, (3, 4, 5)).astype(np.float32)
    for k, (node, vol) in enumerate(((0, None), (3, grid), (5, None))):
        assert [sc.create_volumetric_fog_region(node, vol)
                for sc in scenes] == [k, k]
    for k, (node, res) in enumerate(((1, (8, 2, 8)), (4, [3.0, 2, 5]))):
        assert [sc.create_volumetric_diffuse_light(res, node)
                for sc in scenes] == [k, k]
    a, b = scenes
    assert a.fog_region_node == b.fog_region_node == [0, 3, 5]
    assert [v is None for v in a.fog_region_volume] == \
        [v is None for v in b.fog_region_volume] == [True, False, True]
    _eq(a.fog_region_volume[1], b.fog_region_volume[1])
    assert a.diffuse_volume_node == b.diffuse_volume_node == [1, 4]
    assert a.diffuse_volume_res == b.diffuse_volume_res \
        == [(8, 2, 8), (3, 2, 5)]
    assert scene_entities(a) == scene_entities(b)
    assert [e.get_component(TS.VolumetricDiffuseLightComponent).index
            for e in a.diffuse_volume_entity] == [0, 1]
    for sc in scenes:
        sc.update_transform_tree()
    _eq(a.world[:6], b.world[:6])


def test_bench_scene_built_through_both():
    """build_bench_scene through the port's copies (muglm, mesh_util,
    scene_formats) equals the JAX package's, mesh by mesh."""
    want, got = jax_bench(), TB.build_bench_scene()
    assert len(want.meshes) == len(got.meshes)
    for a, b in zip(want.meshes, got.meshes):
        _same_mesh(a, b)
    assert len(want.nodes) == len(got.nodes)
    for a, b in zip(want.nodes, got.nodes):
        _eq(a.rotation, b.rotation)
        _eq(a.translation, b.translation)
        assert a.meshes == b.meshes and a.light == b.light


def test_image_io_round_trip(tmp_path):
    rng = _rng()
    img = rng.integers(0, 256, size=(9, 13, 4)).astype(np.uint8)
    path = os.path.join(tmp_path, "x.png")
    save_png(path, img)
    for srgb in (False, True):
        _eq(load_image(path, srgb), jax_load_image(path, srgb))
    _eq(load_image(path), img)
