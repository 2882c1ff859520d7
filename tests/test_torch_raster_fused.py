"""Port parity for the fused raster + resolve (kernel B2's plain version,
granite_tpu_torch/ops/raster_fused.py) against the JAX reference's
rasterize_resolve in Pallas interpret mode and against the classic
binned raster + interpolate_with_derivs (test_raster_fused.py's
tolerances), on identical inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from granite_tpu.math.muglm import look_at_matrix, perspective
from granite_tpu.ops import raster as JR
from granite_tpu.ops import raster_fused as JF
from granite_tpu.renderer import scene_renderer as JS
from granite_tpu.scene.mesh_util import cube_mesh, plane_mesh, sphere_mesh
from granite_tpu.scene.scene_formats import MaterialData, NodeData, SceneInfo
from granite_tpu_torch import convert
from granite_tpu_torch.ops import raster_fused as TF
from granite_tpu_torch.renderer import scene_renderer as TS

W, H = 128, 96


def _scene():
    info = SceneInfo()
    img = np.zeros((16, 16, 4), np.uint8)
    img[::2, ::2] = 255
    img[..., 3] = 255
    info.images = [img]
    info.image_srgb = [False]
    info.materials = [
        MaterialData(name="a", base_color_image=0, roughness_factor=0.5),
        MaterialData(name="b",
                     base_color_factor=np.array([1, 0.5, 0.25, 1],
                                                np.float32),
                     metallic_factor=0.8,
                     emissive_factor=np.array([0.1, 0.2, 0.3], np.float32)),
    ]
    info.meshes = [plane_mesh(0), cube_mesh(1), sphere_mesh(12, 1)]
    info.nodes = [
        NodeData(name="floor", meshes=[0],
                 scale=np.array([4, 1, 4], np.float32)),
        NodeData(name="cube", meshes=[1],
                 translation=np.array([0, 1, 0], np.float32)),
        NodeData(name="ball", meshes=[2],
                 translation=np.array([1.5, 1, 0.5], np.float32),
                 scale=np.full(3, 0.6, np.float32)),
    ]
    info.roots = [0, 1, 2]
    return info


@pytest.fixture(scope="module")
def inputs():
    info = _scene()
    packed = JS.pack_scene(info, texture_size=16)
    n = packed.num_nodes
    world = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i, nd in enumerate(info.nodes):
        world[i, 0, 0], world[i, 1, 1], world[i, 2, 2] = nd.scale
        world[i, :3, 3] = nd.translation
    nm = np.linalg.inv(world[:, :3, :3]).transpose(0, 2, 1)
    vp = (perspective(1.0, W / H, 0.1)
          @ look_at_matrix([4.0, 3.0, 6.0], [0, 0.5, 0], [0, 1, 0]))
    clip, wpos, wnrm, wtan = JS.transform_vertices(
        packed, jnp.asarray(world), jnp.asarray(nm.astype(np.float32)),
        jnp.asarray(vp.astype(np.float32)))
    setup = JR.setup_triangles(clip, packed.indices, W, H)
    extra = JF.build_resolve_extra(packed, wpos, wnrm, wtan,
                                   prev_world_pos=wpos)
    ref = np.asarray(JF.rasterize_resolve(setup, extra, W, H,
                                          interpret=True, has_prev=True))
    return dict(packed=packed, world=world, nm=nm, vp=vp, clip=clip,
                wpos=wpos, wnrm=wnrm, wtan=wtan, setup=setup, extra=extra,
                ref=ref)


def _port_planes(inp, **kw):
    return TF.rasterize_resolve(convert.triangle_setup(inp["setup"]),
                                convert.tensor(inp["extra"]), W, H,
                                has_prev=True, **kw).numpy()


def test_build_resolve_extra_matches(inputs):
    tp = convert.packed_scene(inputs["packed"])
    got = TF.build_resolve_extra(tp, convert.tensor(inputs["wpos"]),
                                 convert.tensor(inputs["wnrm"]),
                                 convert.tensor(inputs["wtan"]),
                                 prev_world_pos=convert.tensor(
                                     inputs["wpos"]))
    assert np.array_equal(got.numpy(), np.asarray(inputs["extra"]))


def test_b2_plain_matches_pallas(inputs):
    ref = inputs["ref"]
    got = _port_planes(inputs)
    assert got.shape == ref.shape == (TF.NUM_PLANES, H, W)
    cov = ref[TF.PLANE_COVERED] > 0.5
    assert cov.sum() > 1000
    assert np.array_equal(got[TF.PLANE_COVERED], ref[TF.PLANE_COVERED])
    assert np.allclose(got[TF.PLANE_DEPTH], ref[TF.PLANE_DEPTH], rtol=2e-6,
                       atol=0)
    # Same formula, but the offset-folded adjugate (a*px + b*py + c')
    # cancels large terms, so XLA-CPU's FMA contraction moves results by
    # ~1e-5 relative: test_raster_fused.py's tolerances.
    derivs = list(range(TF.PLANE_DUVDX, TF.PLANE_DUVDY + 2))
    rest = [p for p in range(TF.NUM_PLANES) if p not in derivs]
    assert np.allclose(got[rest], ref[rest], rtol=2e-4, atol=2e-4)
    assert np.allclose(got[derivs], ref[derivs], rtol=5e-3, atol=5e-5)


def test_b2_plain_matches_classic_resolve(inputs):
    setup = inputs["setup"]
    depth_ref, tri_ref = JR.rasterize(setup, W, H)
    px, py = JR.pixel_centers(W, H)
    vattrs = jnp.concatenate([inputs["wpos"], inputs["wnrm"],
                              inputs["wtan"], inputs["packed"].uvs], axis=1)
    vals, ddx, ddy = JR.interpolate_with_derivs(
        vattrs, inputs["packed"].indices, tri_ref, setup, px, py)
    vals, ddx, ddy = (np.asarray(a) for a in (vals, ddx, ddy))
    planes = _port_planes(inputs)
    m = np.asarray(tri_ref) >= 0
    assert np.array_equal(planes[TF.PLANE_COVERED] > 0.5, m)
    assert np.allclose(planes[TF.PLANE_DEPTH], np.asarray(depth_ref),
                       atol=1e-6)
    for k in range(3):
        for plane, col in ((TF.PLANE_POS, 0), (TF.PLANE_NRM, 3),
                           (TF.PLANE_PREV, 0)):
            assert np.allclose(planes[plane + k][m], vals[..., col + k][m],
                               rtol=2e-4, atol=2e-4)
    for k in range(4):
        assert np.allclose(planes[TF.PLANE_TAN + k][m], vals[..., 6 + k][m],
                           rtol=2e-4, atol=2e-4)
    for k in range(2):
        assert np.allclose(planes[TF.PLANE_UV + k][m], vals[..., 10 + k][m],
                           rtol=2e-4, atol=2e-4)
        assert np.allclose(planes[TF.PLANE_DUVDX + k][m],
                           ddx[..., 10 + k][m], rtol=5e-3, atol=5e-5)
        assert np.allclose(planes[TF.PLANE_DUVDY + k][m],
                           ddy[..., 10 + k][m], rtol=5e-3, atol=5e-5)
    packed = inputs["packed"]
    mat = np.asarray(packed.tri_material)[np.maximum(np.asarray(tri_ref), 0)]
    for plane, table, c in ((TF.PLANE_BASE, packed.mat_base_color, 0),
                            (TF.PLANE_MR, packed.mat_mr, 0),
                            (TF.PLANE_EMISSIVE + 2, packed.mat_emissive, 2)):
        assert np.allclose(planes[plane][m], np.asarray(table)[mat][..., c][m],
                           atol=1e-6)
    assert np.allclose(planes[TF.PLANE_BUNDLE][m],
                       np.asarray(packed.mat_bundle)[mat][m], atol=1e-6)


def test_compaction_with_room_is_identical(inputs):
    nvis = int(np.asarray(inputs["setup"].valid).sum())
    full = _port_planes(inputs)
    assert np.array_equal(full, _port_planes(inputs, max_visible=nvis))
    _, stats = TF.rasterize_resolve(
        convert.triangle_setup(inputs["setup"]),
        convert.tensor(inputs["extra"]), W, H, has_prev=True,
        max_visible=nvis // 4, with_stats=True)
    assert int(stats["visible_overflow"]) > 0


def test_fused_raster_surface_matches(inputs):
    """G-buffer surf dict (B2 + the B3 material fetch) vs the reference's
    fused_raster_surface (interpret mode; classic sample_packed_lod)."""
    packed = inputs["packed"]
    mask = jnp.ones((packed.num_objects,), bool)
    jsurf, jdepth = JS.fused_raster_surface(
        packed, inputs["clip"], mask, inputs["wpos"], inputs["wnrm"],
        inputs["wtan"], W, H, interpret=True)
    tp = convert.packed_scene(packed)
    tsurf, tdepth, _ = TS.fused_raster_surface(
        tp, convert.tensor(inputs["clip"]), torch.ones(packed.num_objects,
                                                       dtype=torch.bool),
        convert.tensor(inputs["wpos"]), convert.tensor(inputs["wnrm"]),
        convert.tensor(inputs["wtan"]), W, H)
    cov = np.asarray(jsurf["covered"])
    assert np.array_equal(cov, tsurf["covered"].numpy())
    assert np.allclose(np.asarray(jdepth), tdepth.numpy(), rtol=1e-5)
    for k in ("pos", "normal", "base_color", "metallic", "roughness",
              "emissive", "alpha"):
        assert np.allclose(np.asarray(jsurf[k])[cov], tsurf[k].numpy()[cov],
                           rtol=1e-4, atol=1e-4), k
