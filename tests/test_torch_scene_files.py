"""Scene files in the port against the JAX package: the glTF parser, the
exporter, the `.scene` loader and the viewer on a loaded, animated scene.

Fixtures (tests/gltf_fixtures.py, written once a module): the golden test
scene written by the JAX exporter, its GLB and data-URI forms, the
skinned character and the morph sheet, and a `.scene` composing the test
scene (with a camera node), one character and the sheet.

Tolerances: parsed records equal field by field with arrays exact; the
exported .gltf, .bin and PNG files byte-equal; renders at the 48 dB luma
gate of the golden images.  Two port-only tests cover what the port does
differently from the reference on purpose: every instance of a skinned
file gets its own skin (the reference shares one, posed by the last
instance's joints), and the renderables follow pack_scene's object
order."""

import filecmp
import json
import os
import types

import numpy as np
import pytest
import torch

import gltf_fixtures as GF
from golden_utils import psnr
from test_torch_slice import _same
from granite_tpu.app.scene_viewer import (
    SceneViewerApplication as JaxViewer, build_default_test_scene,
)
from granite_tpu.scene.gltf import GLTFParser as JaxParser
from granite_tpu.scene.scene_loader import SceneLoader as JaxLoader
from granite_tpu.scene_export import export_gltf as jax_export
from granite_tpu_torch.app import bench_scene as TB
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.renderer.scene_renderer import (
    pack_scene, render_shadow_map,
)
from granite_tpu_torch.scene.gltf import GLTFParser
from granite_tpu_torch.scene.scene_loader import SceneLoader
from granite_tpu_torch.scene_export import export_gltf

GATE_DB = 48.0
SIZE = (128, 72)
TIME_STEP = 1.0 / 60.0
# the deferred golden configs' knobs; no clustered light shadows (the
# plain B1 takes ~16 s on one CPU thread for the atlas's 25 slices over
# the character's 24,576 triangles; chip_smoke.py's cross-device check
# renders this scene with them)
CONFIG = {"renderer": "deferred", "hdrBloom": True,
          "shadowMapResolution": 64, "clusteredLightsShadows": False}
EYE, TARGET = (7.0, 5.5, 9.0), (0.0, 0.8, 0.0)
CHARACTER_AT, SHEET_AT = (2.5, 1.2, 2.5), (-2.5, 0.1, 2.5)


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
    d = tmp_path_factory.mktemp("scene_files")
    jax_export(build_default_test_scene(), str(d / "test.gltf"))
    GF.to_glb(str(d / "test.gltf"), str(d / "test.glb"))
    GF.to_data_uris(str(d / "test.gltf"), str(d / "test_inline.gltf"))
    jax_export(build_default_test_scene(), str(d / "test_cam.gltf"))
    GF.add_camera(str(d / "test_cam.gltf"), EYE, TARGET)
    GF.write_scene(str(d / "anim.scene"), "test_cam.gltf", [CHARACTER_AT],
                   SHEET_AT)
    with open(d / "ocean_terrain.scene", "w") as f:
        json.dump({"scenes": [{"path": "test_cam.gltf"}],
                   "ocean": True,
                   "terrain": {"worldSize": 40.0, "grid": 16}}, f)
    with open(d / "twice.scene", "w") as f:
        json.dump({"scenes": [{"path": "character.gltf", "instances": [
            {"translation": [-4.0, 0.0, 0.0]},
            {"translation": [4.0, 0.0, 0.0]}]}]}, f)
    with open(d / "cfg.json", "w") as f:
        json.dump(CONFIG, f)
    return d


@pytest.mark.parametrize("name", ["test.gltf", "test.glb", "test_inline.gltf",
                                  "character.gltf", "morph.gltf"])
def test_parser_matches_jax(files, name):
    want = JaxParser(str(files / name)).get_scene()
    got = GLTFParser(str(files / name)).get_scene()
    _same(want, got)
    assert len(got.meshes) > 0
    if name == "character.gltf":
        md = got.meshes[0]
        assert len(md.indices) == GF.CHARACTER_TRIANGLES
        assert md.joints.shape == md.weights.shape == (len(md.positions), 4)
        assert len(got.skins[0].joints) == 1 + GF.LIMBS * GF.JOINTS_PER_LIMB
        assert {c["interp"] for c in got.animations[0].channels} == {
            "LINEAR", "CUBICSPLINE", "STEP"}
    if name == "morph.gltf":
        md = got.meshes[0]
        assert len(md.indices) == GF.SHEET_TRIANGLES
        assert len(md.morph_position_deltas) == GF.MORPH_TARGETS
        assert got.animations[0].channels[0]["path"] == "weights"


@pytest.mark.parametrize("name", ["test", "character.gltf", "morph.gltf"])
def test_export_is_byte_equal(files, tmp_path, name):
    """The port's export_gltf writes the JAX exporter's files byte for
    byte: the test scene (images, lights, materials), and the parsed
    character (skins, every interpolation) and sheet (weights)."""
    if name == "test":
        want_info, got_info = build_default_test_scene(), \
            TB.build_default_test_scene()
    else:
        want_info = JaxParser(str(files / name)).get_scene()
        got_info = GLTFParser(str(files / name)).get_scene()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_export(want_info, str(tmp_path / "jax" / "out.gltf"))
    export_gltf(got_info, str(tmp_path / "port" / "out.gltf"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert {"out.gltf", "out.bin"} <= set(names)
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", names, shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(names)


def test_scene_loader_matches_jax(files):
    """One instance of a glTF with a camera, and the ocean and terrain
    blocks: the same records and configs as the JAX loader's, but for
    the camera's node, which the port remaps onto the instance (the
    reference leaves it in the source file's numbering)."""
    want = JaxLoader(str(files / "ocean_terrain.scene"))
    got = SceneLoader(str(files / "ocean_terrain.scene"))
    assert got.ocean_config == want.ocean_config == {}
    assert got.terrain_config == want.terrain_config == {
        "worldSize": 40.0, "grid": 16}
    (cam,) = got.info.cameras
    assert got.info.nodes[cam.node].name == "camera"
    assert cam.node == want.info.cameras[0].node + 1
    assert want.info.nodes[want.info.cameras[0].node].name != "camera"
    want.info.cameras[0].node = cam.node
    _same(want.info, got.info)


def test_each_instance_is_skinned_by_its_own_joints(files):
    """A character instanced twice (port only).  The reference's loader
    keeps one skin whose joints are the second instance's, so both
    meshes pose onto the second instance; the port gives each instance
    its own skin, and each posed mesh stays around its own root."""
    want = JaxLoader(str(files / "twice.scene")).get_scene()
    assert len(want.skins) == 1
    got = SceneLoader(str(files / "twice.scene")).get_scene()
    assert len(got.skins) == 2
    mesh_nodes = [n for n in got.nodes if n.meshes]
    assert [n.skin for n in mesh_nodes] == [0, 1]
    per_instance = len(got.nodes) // 2
    assert np.array_equal(got.skins[1].joints,
                          got.skins[0].joints + per_instance)
    assert np.array_equal(want.skins[0].joints, got.skins[1].joints)
    app = SceneViewerApplication(types.SimpleNamespace(
        config=str(files / "cfg.json"), bench_scene=False,
        scene=str(files / "twice.scene"), camera_index=-1), device="cpu")
    app.animation_system.animate(0.7)
    app.scene.update_transform_tree()
    from granite_tpu_torch.renderer.scene_renderer import world_positions
    pos = world_positions(app.packed, app._t(app.scene.world),
                          app._skin_palette()).numpy()
    half = len(pos) // 2
    for part, x in ((pos[:half], -4.0), (pos[half:], 4.0)):
        assert abs(float(part[:, 0].mean()) - x) < 1.0


def _morph_first_info(module):
    """A scene whose morph-only mesh comes before a plain mesh in node
    order, built with `module`'s records."""
    info = module.SceneInfo()
    plain = module.MeshData(
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32))
    morph = module.MeshData(
        positions=np.array([[5, 0, 0], [6, 0, 0], [5, 1, 0]], np.float32),
        morph_position_deltas=[np.ones((3, 3), np.float32)])
    info.meshes = [plain.finalize(), morph.finalize()]
    info.nodes = [module.NodeData(name="root", children=[1, 2]),
                  module.NodeData(name="sheet", meshes=[1]),
                  module.NodeData(name="plain", meshes=[0])]
    info.roots = [0]
    return info


def test_renderables_follow_pack_order():
    """With a morph-only mesh before a plain one in node order (port
    only): the port registers its renderables in pack_scene's object
    order, so renderable i culls packed object i; the JAX viewer sorts on
    "skinned" alone, and its renderable 0 is the morph sheet while
    packed object 0 is the plain mesh, so its culling masks land on the
    wrong objects."""
    from granite_tpu.scene import scene_formats as JSF
    from granite_tpu_torch.scene import scene_formats as TSF
    got = SceneViewerApplication._build_runtime_scene(
        None, _morph_first_info(TSF))
    packed = pack_scene(_morph_first_info(TSF))
    assert list(packed.obj_node) == [2, 1]
    assert list(got.r_node) == list(packed.obj_node)
    want = JaxViewer._build_runtime_scene(None, _morph_first_info(JSF))
    assert list(want.r_node) == [1, 2]


def test_dynamic_shadow_subset_is_exact(files):
    """The dynamic casters' sun map set up over their own triangles only
    equals the map of every triangle with the others masked off."""
    app = SceneViewerApplication(types.SimpleNamespace(
        config=str(files / "cfg.json"), bench_scene=False,
        scene=str(files / "anim.scene"), camera_index=0), device="cpu")
    app.swapchain_updated(*SIZE)
    app.animation_system.animate(0.3)
    p = app.build_frame_params(TIME_STEP, 0.3)
    assert app._has_dynamic_casters and p["dynamic_shadow_mask"].any()
    args = (app.packed, p["external"]["world"], p["shadow_vp"], 64,
            p["dynamic_shadow_mask"])
    kw = dict(skin_palette=p["skin_palette"],
              morph_weights=p["morph_weights"])
    sub = render_shadow_map(*args, tris=app._dynamic_tris, **kw)
    full = render_shadow_map(*args, **kw)
    assert torch.equal(sub, full) and bool((sub > 0).any())


def _jax_app(files, config_path, port_app):
    """The JAX viewer on the same files.  Its camera takes the port's
    pose: the JAX loader leaves scene cameras on the wrong node
    (test_scene_loader_matches_jax)."""
    app = JaxViewer(types.SimpleNamespace(
        config=config_path, bench_scene=False, quirks=None,
        scene=str(files / "anim.scene"), camera_index=0))
    app.camera.position = port_app.camera.position.copy()
    app.camera.rotation = port_app.camera.rotation.copy()
    return app


@pytest.mark.parametrize("post_aa", ["none", "taa"])
def test_animated_scene_matches_jax_render(files, post_aa):
    """The `.scene` through both viewers at 128x72, camera 0, frames at
    elapsed 0 and 0.5 s (the skinned character, the morph sheet, the
    dynamic casters' sun map; under TAA the motion vectors of the posed
    meshes), each frame at the 48 dB gate; the animation moves the
    frame."""
    path = str(files / f"{post_aa}.json")
    with open(path, "w") as f:
        json.dump(dict(CONFIG, postAA=post_aa), f)
    port = SceneViewerApplication(types.SimpleNamespace(
        config=path, bench_scene=False,
        scene=str(files / "anim.scene"), camera_index=0), device="cpu")
    jax_app = _jax_app(files, path, port)
    frames = []
    for app in (port, jax_app):
        app.swapchain_updated(*SIZE)
        frames.append([np.asarray(app.render_frame(TIME_STEP, t))
                       for t in (0.0, 0.5)])
    (p0, p1), (j0, j1) = frames
    assert p0.shape == j0.shape == (SIZE[1], SIZE[0], 4)
    assert psnr(p0, j0) >= GATE_DB and psnr(p1, j1) >= GATE_DB
    assert np.abs(p0.astype(int) - p1).max() > 8


@pytest.mark.parametrize("kind", ["perspective", "orthographic"])
def test_scene_camera_matches_jax(files, kind):
    """camera_index 0 of a .gltf loaded directly (no .scene, so the JAX
    loader's camera node is right): the same pose, lens and projection
    as the JAX viewer's _setup_camera."""
    path = files / f"cam_{kind}.gltf"
    doc = json.loads((files / "test_cam.gltf").read_text())
    if kind == "orthographic":
        doc["cameras"][0] = {"type": "orthographic", "orthographic": {
            "xmag": 6.0, "ymag": 4.0, "znear": 0.5, "zfar": 60.0}}
    path.write_text(json.dumps(doc))
    got = SceneViewerApplication(types.SimpleNamespace(
        config=str(files / "cfg.json"), bench_scene=False, scene=str(path),
        camera_index=0), device="cpu")
    want = JaxViewer._setup_camera(
        types.SimpleNamespace(info=JaxParser(str(path)).get_scene(),
                              scene=got.scene),
        types.SimpleNamespace(camera_index=0))
    cam = got.camera
    for k in ("position", "rotation"):
        assert np.array_equal(getattr(cam, k), getattr(want, k)), k
    assert (cam.fovy, cam.znear, cam.zfar) == (want.fovy, want.znear,
                                               want.zfar)
    assert np.array_equal(cam.get_projection(), want.get_projection())
    assert np.allclose(cam.position, EYE, atol=1e-5)
    with pytest.raises(ValueError):
        SceneViewerApplication(types.SimpleNamespace(
            config=None, bench_scene=False, scene=str(path),
            camera_index=1), device="cpu")


def test_rescale_scene(files):
    """rescaleScene scales every root by 10 / the radius of the scene's
    bounds, as the JAX viewer does: a scene under one root at the origin
    then has radius 10; instances keep their root translations."""
    def bounds_radius(app):
        sc = app.scene
        sc.update_transform_tree()
        return 0.5 * float(np.linalg.norm(sc.r_world_max.max(0)
                                          - sc.r_world_min.min(0)))

    def app(scene, rescale):
        path = files / f"rescale_{rescale}.json"
        path.write_text(json.dumps(dict(CONFIG, rescaleScene=rescale)))
        return SceneViewerApplication(types.SimpleNamespace(
            config=str(path), bench_scene=False, scene=str(files / scene),
            camera_index=-1), device="cpu")

    assert abs(bounds_radius(app("test.gltf", True)) - 10.0) < 1e-3
    factor = 10.0 / bounds_radius(app("twice.scene", False))
    scaled = app("twice.scene", True)
    roots = scaled.info.roots
    assert np.allclose(scaled.scene.scale[roots], factor, rtol=1e-6)
    assert np.array_equal(scaled.scene.translation[roots],
                          [[-4, 0, 0], [4, 0, 0]])
