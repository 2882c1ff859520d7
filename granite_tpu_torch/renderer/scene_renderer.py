"""Packed scene + the deferred frame stages (port of
granite_tpu/renderer/scene_renderer.py: the fused/kernel route).

PackedScene holds every mesh primitive in one set of global vertex /
index buffers with per-triangle material and object ids (the
reference's SoA mesh pools).  Per frame:

  1. vertex transform (matmuls; TF32 is off, core/device.py);
  2. triangle setup + binning + kernel B2 -> 32 G-buffer planes;
  3. material fetch through kernel B3 + normal mapping;
  4. lighting: shadow term, env products (B3), top-K cluster shadows,
     then kernel B4 for the whole shade expression.

Shadow maps (sun and clustered-light atlas) are depth-only rasters
through kernel B1.  The classic route (rasterize_scene: B1 on a camera
view, then surface_attributes: the visibility-buffer resolve and B3)
serves occlusion culling and the volumetric diffuse bake, as it does in
the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..assets.texture_array import (
    FLAT_NORMAL_TEXTURE, NUM_BUILTIN_TEXTURES, TextureArrayBuilder,
    WHITE_TEXTURE,
)
from ..ops import raster as R
from ..ops.hdr import resize_bilinear, uv_grid
from ..ops.light_shadows import topk_shadow_terms
from ..ops.raster_binned import rasterize_binned
from ..ops.raster_fused import (
    PLANE_BASE, PLANE_BUNDLE, PLANE_COVERED, PLANE_DEPTH, PLANE_DUVDX,
    PLANE_DUVDY, PLANE_EMISSIVE, PLANE_MR, PLANE_NRM, PLANE_POS, PLANE_PREV,
    PLANE_TAN, PLANE_UV, build_resolve_extra, rasterize_resolve,
)
from ..ops.shade_fused import (
    CLUSTER_TILE, P_FIXED, fused_light_table, shade_planes_fused,
)
from ..ops.shadow import (
    sample_cascaded_shadow, sample_directional_shadow, sample_vsm_shadow,
    sample_vsm_shadow_tiled,
)
from ..ops.texture import build_packed_lod_strip_np, lod_from_derivs
from ..ops.tile_sampler import sample_lod
from ..scene.scene import (
    RENDERABLE_CASTS_SHADOW, RENDERABLE_DYNAMIC, RENDERABLE_OPAQUE,
    RENDERABLE_TRANSPARENT,
)
from ..scene.scene_formats import ALPHA_MODE_BLEND, SceneInfo
from ..utils.logging import LOGI
from ..utils.timeline_trace import span, upload
from .environment import analytic_sky, eval_sh9, sample_environment
from .raster_dispatch import bin_window, rasterize_binned_exact
from .volumetric_diffuse import sample_volumetric_diffuse

MATERIAL_CHANNELS = 12   # base rgba | mr g,b | normal xyz | emissive rgb


@dataclass
class PackedScene:
    positions: torch.Tensor        # (V, 3) f32 object space
    normals: torch.Tensor          # (V, 3)
    uvs: torch.Tensor              # (V, 2)
    tangents: torch.Tensor         # (V, 4)
    v_node: torch.Tensor           # (V,) int32
    indices: torch.Tensor          # (T, 3) int32
    tri_material: torch.Tensor     # (T,) int32
    tri_object: torch.Tensor       # (T,) int32
    mat_base_color: torch.Tensor   # (M, 4)
    mat_mr: torch.Tensor           # (M, 2) metallic, roughness
    mat_emissive: torch.Tensor     # (M, 3)
    mat_bundle: torch.Tensor       # (M,) int32
    mat_alpha: torch.Tensor        # (M, 2) mode, cutoff
    mat_two_sided: torch.Tensor    # (M,) int32
    bundles: torch.Tensor          # (B, HS-1, S, 60) f16 LOD strips
    obj_node: np.ndarray           # host culling table
    obj_aabb_min: np.ndarray
    obj_aabb_max: np.ndarray
    obj_flags: np.ndarray
    num_objects: int
    num_nodes: int
    num_static_verts: int = 0
    v_joints: torch.Tensor | None = None
    v_weights: torch.Tensor | None = None
    morph_v0: int = -1
    morph_nodes: list = field(default_factory=list)
    morph_default_weights: np.ndarray | None = None
    v_morph_inst: torch.Tensor | None = None
    morph_deltas: torch.Tensor | None = None
    morph_normal_deltas: torch.Tensor | None = None
    has_normal_maps: bool = True
    has_mr_textures: bool = True
    has_emissive: bool = True
    # texture streaming: the TextureStreamer that owns `bundles`
    streamer: object = None

    DEVICE_FIELDS = ("positions", "normals", "uvs", "tangents", "v_node",
                     "indices", "tri_material", "tri_object",
                     "mat_base_color", "mat_mr", "mat_emissive",
                     "mat_bundle", "mat_alpha", "mat_two_sided",
                     "bundles", "v_joints", "v_weights", "v_morph_inst",
                     "morph_deltas", "morph_normal_deltas")



def material_bundle_plan(mat_tex: np.ndarray):
    """Dedupe materials by (base, mr, normal, emissive) texture tuple ->
    (mat_bundle (M,) int32, bundle_keys)."""
    bundle_of: dict = {}
    bundle_keys: list = []
    mat_bundle = np.zeros(mat_tex.shape[0], np.int32)
    for i in range(mat_tex.shape[0]):
        key = tuple(int(t) for t in mat_tex[i])
        if key not in bundle_of:
            bundle_of[key] = len(bundle_keys)
            bundle_keys.append(key)
        mat_bundle[i] = bundle_of[key]
    return mat_bundle, bundle_keys


def pack_material_channels(images_rgba: list) -> np.ndarray:
    """[base, mr, normal, emissive] RGBA -> 12 channels (mr.G roughness,
    mr.B metallic; normal/emissive alpha dropped)."""
    base, mr, normal, emissive = images_rgba
    return np.concatenate([base[..., 0:4], mr[..., 1:3],
                           normal[..., 0:3], emissive[..., 0:3]], axis=-1)


def build_bundle_strip(images_rgba: list) -> np.ndarray:
    """4 linear material images [base, mr, normal, emissive] -> one
    60-channel f16 LOD strip (the 12 channels quad-packed, with the
    parent tap)."""
    return build_packed_lod_strip_np(pack_material_channels(images_rgba))


BLOCK_PLAIN, BLOCK_MORPH, BLOCK_MORPH_SKIN, BLOCK_SKIN = range(4)


def mesh_instances(info: SceneInfo) -> list:
    """Every (block, node, mesh) instance of the scene in pack_scene's
    object order: node order within the blocks plain | morph | morph+skin
    | skin (a stable sort on the block).  The viewer registers its
    renderables in this order, so a renderable's row is its object id."""
    out = []
    for node_idx, nd in enumerate(info.nodes):
        for mesh_idx in nd.meshes:
            md = info.meshes[mesh_idx]
            skinned = nd.skin is not None and md.joints is not None
            morphed = md.morph_position_deltas is not None
            block = (BLOCK_MORPH if morphed and not skinned else
                     BLOCK_MORPH_SKIN if morphed and skinned else
                     BLOCK_SKIN if skinned else BLOCK_PLAIN)
            out.append((block, node_idx, mesh_idx))
    out.sort(key=lambda x: x[0])
    return out


def pack_scene(info: SceneInfo, texture_size: int = 512, device="cpu",
               texture_streaming: bool = False,
               texture_budget=None) -> PackedScene:
    """Flatten SceneInfo into global buffers on `device` (instances in
    the reference's block order: plain | morph | morph+skin | skin).

    texture_streaming: the images are not decoded here; their texture ids
    are assigned in order, and a TextureStreamer (assets/streaming.py)
    owns `bundles`: all fallbacks at first, rows latched in as images
    become resident under texture_budget bytes (None: no limit)."""
    tb = None
    if texture_streaming:
        img_to_tex = {i: NUM_BUILTIN_TEXTURES + i
                      for i in range(len(info.images))}
    else:
        tb = TextureArrayBuilder(texture_size)
        img_to_tex = {i: tb.add_image(img, info.image_srgb[i])
                      for i, img in enumerate(info.images)}

    def tex_of(img_idx, fallback):
        return img_to_tex.get(img_idx, fallback) if img_idx is not None \
            else fallback

    M = max(len(info.materials), 1)
    mat_base = np.ones((M, 4), np.float32)
    mat_mr = np.ones((M, 2), np.float32) * np.array([[0.0, 1.0]], np.float32)
    mat_emissive = np.zeros((M, 3), np.float32)
    mat_tex = np.zeros((M, 4), np.int32)
    mat_tex[:, 0] = WHITE_TEXTURE
    mat_tex[:, 1] = WHITE_TEXTURE
    mat_tex[:, 2] = FLAT_NORMAL_TEXTURE
    mat_tex[:, 3] = WHITE_TEXTURE
    mat_alpha = np.zeros((M, 2), np.float32)
    mat_alpha[:, 1] = 0.5
    mat_two_sided = np.zeros(M, np.int32)
    for i, m in enumerate(info.materials):
        mat_base[i] = m.base_color_factor
        mat_mr[i] = [m.metallic_factor, m.roughness_factor]
        mat_emissive[i] = m.emissive_factor
        mat_tex[i] = [tex_of(m.base_color_image, WHITE_TEXTURE),
                      tex_of(m.metallic_roughness_image, WHITE_TEXTURE),
                      tex_of(m.normal_image, FLAT_NORMAL_TEXTURE),
                      tex_of(m.emissive_image, WHITE_TEXTURE)]
        mat_alpha[i] = [float(m.alpha_mode), m.alpha_cutoff]
        mat_two_sided[i] = int(m.two_sided)
    mat_bundle, bundle_keys = material_bundle_plan(mat_tex)
    streamer = None
    if texture_streaming:
        from ..assets.streaming import TextureStreamer
        streamer = TextureStreamer(
            info, bundle_keys, {t: i for i, t in img_to_tex.items()},
            texture_size, budget_bytes=texture_budget, device=device)
        bundles = streamer.initial_bundles()
    else:
        bundles = torch.as_tensor(np.stack([build_bundle_strip(
            [tb._images[t] for t in key]) for key in bundle_keys]),
            device=device)

    skin_offsets = []
    off = 0
    for sk in info.skins:
        skin_offsets.append(off)
        off += len(sk.joints)
    instances = [(block, node_idx, info.meshes[mesh_idx],
                  info.nodes[node_idx])
                 for block, node_idx, mesh_idx in mesh_instances(info)]
    mt_max = max((len(md.morph_position_deltas)
                  for _b, _n, md, _nd in instances
                  if md.morph_position_deltas is not None), default=0)
    any_morph_nrm = any(md.morph_normal_deltas is not None
                        for _b, _n, md, _nd in instances)

    pos_l, nrm_l, uv_l, tan_l, vnode_l = [], [], [], [], []
    idx_l, trimat_l, triobj_l = [], [], []
    obj_node, obj_min, obj_max, obj_flags = [], [], [], []
    joints_l, weights_l = [], []
    v_morph_inst_l, morph_pos_l, morph_nrm_l = [], [], []
    morph_nodes, morph_defaults = [], []
    morph_v0 = -1
    num_static_verts = 0
    v_off = 0
    for block, node_idx, md, nd in instances:
        if md.encoding == "meshlet" and md.positions is None:
            # MLT2 streams materialize to SoA at instantiation
            # (MeshEncoding::MeshletDecoded).
            md.decode_meshlets()
        v = len(md.positions)
        t = len(md.indices)
        pos_l.append(md.positions)
        nrm_l.append(md.normals)
        uv_l.append(md.uvs)
        tan_l.append(md.tangents)
        vnode_l.append(np.full(v, node_idx, np.int32))
        idx_l.append(md.indices + v_off)
        mat = max(md.material, 0)
        trimat_l.append(np.full(t, mat, np.int32))
        triobj_l.append(np.full(t, len(obj_node), np.int32))
        obj_node.append(node_idx)
        obj_min.append(md.aabb_min)
        obj_max.append(md.aabb_max)
        mode = info.materials[mat].alpha_mode if info.materials else 0
        flags = RENDERABLE_CASTS_SHADOW | (
            RENDERABLE_TRANSPARENT if mode == ALPHA_MODE_BLEND
            else RENDERABLE_OPAQUE)
        if block in (BLOCK_MORPH_SKIN, BLOCK_SKIN):
            flags |= RENDERABLE_DYNAMIC
            joints_l.append(md.joints + skin_offsets[nd.skin])
            w = md.weights if md.weights is not None else \
                np.tile(np.array([1, 0, 0, 0], np.float32), (v, 1))
            weights_l.append((w / np.maximum(w.sum(axis=1, keepdims=True),
                                             1e-9)).astype(np.float32))
        else:
            num_static_verts += v
        if block in (BLOCK_MORPH, BLOCK_MORPH_SKIN):
            flags |= RENDERABLE_DYNAMIC
            if morph_v0 < 0:
                morph_v0 = v_off
            morph_nodes.append(node_idx)
            dw = np.zeros(mt_max, np.float32)
            defaults = nd.morph_weights if nd.morph_weights is not None \
                else md.default_morph_weights
            if defaults is not None:
                dw[:len(defaults)] = defaults
            morph_defaults.append(dw)
            v_morph_inst_l.append(np.full(v, len(morph_nodes) - 1,
                                          np.int32))
            dp = np.zeros((v, mt_max, 3), np.float32)
            for ti, d in enumerate(md.morph_position_deltas):
                dp[:, ti] = d
            morph_pos_l.append(dp)
            if any_morph_nrm:
                dn = np.zeros((v, mt_max, 3), np.float32)
                if md.morph_normal_deltas is not None:
                    for ti, d in enumerate(md.morph_normal_deltas):
                        dn[:, ti] = d
                morph_nrm_l.append(dn)
        obj_flags.append(flags)
        v_off += v
    if not pos_l:
        raise ValueError("scene has no mesh instances")

    def f32(parts):
        return torch.as_tensor(np.concatenate(parts).astype(np.float32),
                               device=device)

    def i32(parts):
        return torch.as_tensor(np.concatenate(parts).astype(np.int32),
                               device=device)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=device)

    ps = PackedScene(
        positions=f32(pos_l), normals=f32(nrm_l), uvs=f32(uv_l),
        tangents=f32(tan_l), v_node=i32(vnode_l), indices=i32(idx_l),
        tri_material=i32(trimat_l), tri_object=i32(triobj_l),
        mat_base_color=dev(mat_base, np.float32),
        mat_mr=dev(mat_mr, np.float32),
        mat_emissive=dev(mat_emissive, np.float32),
        mat_bundle=dev(mat_bundle, np.int32),
        mat_alpha=dev(mat_alpha, np.float32),
        mat_two_sided=dev(mat_two_sided, np.int32),
        bundles=bundles, streamer=streamer,
        obj_node=np.asarray(obj_node, np.int32),
        obj_aabb_min=np.asarray(obj_min, np.float32),
        obj_aabb_max=np.asarray(obj_max, np.float32),
        obj_flags=np.asarray(obj_flags, np.int32),
        num_objects=len(obj_node), num_nodes=len(info.nodes),
        num_static_verts=num_static_verts,
        v_joints=i32(joints_l) if joints_l else None,
        v_weights=f32(weights_l) if weights_l else None,
        morph_v0=morph_v0, morph_nodes=morph_nodes,
        morph_default_weights=(np.stack(morph_defaults)
                               if morph_defaults else None),
        v_morph_inst=i32(v_morph_inst_l) if v_morph_inst_l else None,
        morph_deltas=f32(morph_pos_l) if morph_pos_l else None,
        morph_normal_deltas=f32(morph_nrm_l) if morph_nrm_l else None,
        has_normal_maps=any(m.normal_image is not None
                            for m in info.materials),
        has_mr_textures=any(m.metallic_roughness_image is not None
                            for m in info.materials),
        has_emissive=any(m.emissive_image is not None
                         or np.any(m.emissive_factor)
                         for m in info.materials))
    LOGI("PackedScene: %d verts, %d tris, %d objects, %d bundles%s on %s",
         ps.positions.shape[0], ps.indices.shape[0], ps.num_objects,
         len(bundle_keys), " (streaming)" if streamer is not None else "",
         device)
    return ps


# ---------------------------------------------------------------------------
# Vertex stage
# ---------------------------------------------------------------------------

def _mat3_apply(m, v):
    """Per-vertex (V, 3, 3) @ (V, 3) -> (V, 3)."""
    return torch.bmm(m, v[..., None])[..., 0]


def apply_morphs(scene: PackedScene, positions, normals=None,
                 morph_weights=None):
    """Blend morph deltas into [morph_v0, morph_v0 + Vm) (before skin /
    node transforms).  morph_weights (NI, MT) per morph instance."""
    if scene.morph_deltas is None or morph_weights is None:
        return positions, normals
    m0 = scene.morph_v0
    vm = scene.morph_deltas.shape[0]
    w = morph_weights[scene.v_morph_inst.long()]
    dp = (scene.morph_deltas * w[..., None]).sum(1)
    positions = torch.cat([positions[:m0], positions[m0:m0 + vm] + dp,
                           positions[m0 + vm:]])
    if normals is not None and scene.morph_normal_deltas is not None:
        dn = (scene.morph_normal_deltas * w[..., None]).sum(1)
        normals = torch.cat([normals[:m0], normals[m0:m0 + vm] + dn,
                             normals[m0 + vm:]])
    return positions, normals


def _skin(scene, skin_palette, p, n=None):
    vs = scene.num_static_verts
    pm = skin_palette[scene.v_joints.long()]          # (Vsk, 4, 4, 4)
    blended = (pm * scene.v_weights[..., None, None]).sum(dim=1)
    spos = _mat3_apply(blended[:, :3, :3], p[vs:]) + blended[:, :3, 3]
    snrm = None if n is None else _mat3_apply(blended[:, :3, :3], n[vs:])
    return spos, snrm


def world_positions(scene: PackedScene, world, skin_palette=None,
                    morph_weights=None):
    """World-space vertex positions (morph + node transform + skin)."""
    wm = world[scene.v_node.long()]
    p, _ = apply_morphs(scene, scene.positions,
                        morph_weights=morph_weights)
    world_pos = _mat3_apply(wm[:, :3, :3], p) + wm[:, :3, 3]
    if scene.v_joints is not None and skin_palette is not None:
        spos, _ = _skin(scene, skin_palette, p)
        world_pos = torch.cat([world_pos[:scene.num_static_verts], spos])
    return world_pos


def project(world_pos, vp):
    """World positions (V, 3) -> clip (V, 4) under a 4x4 view-proj."""
    clip = world_pos @ vp[:3, :3].T + vp[:3, 3]
    clip_w = world_pos @ vp[3, :3] + vp[3, 3]
    return torch.cat([clip, clip_w[:, None]], dim=1)


def transform_vertices(scene: PackedScene, world, normal_mats, view_proj,
                       skin_palette=None, morph_weights=None,
                       displace_fn=None):
    """-> (clip (V, 4), world_pos (V, 3), world_normal (V, 3),
    world_tangent (V, 4)).  displace_fn(world_pos, world_normal) ->
    (pos, normal): procedural vertex displacement (ocean and terrain
    heightfields, the analogue of ocean.vert's heightmap fetch), applied
    before projection."""
    node = scene.v_node.long()
    wm = world[node]
    p, base_normals = apply_morphs(scene, scene.positions, scene.normals,
                                   morph_weights)
    world_pos = _mat3_apply(wm[:, :3, :3], p) + wm[:, :3, 3]
    world_normal = _mat3_apply(normal_mats[node], base_normals)
    if scene.v_joints is not None and skin_palette is not None:
        vs = scene.num_static_verts
        spos, snrm = _skin(scene, skin_palette, p, base_normals)
        world_pos = torch.cat([world_pos[:vs], spos])
        world_normal = torch.cat([world_normal[:vs], snrm])
    if displace_fn is not None:
        world_pos, world_normal = displace_fn(world_pos, world_normal)
    world_tan = _mat3_apply(wm[:, :3, :3], scene.tangents[:, :3])
    world_tangent = torch.cat([world_tan, scene.tangents[:, 3:4]], dim=1)
    return project(world_pos, view_proj), world_pos, world_normal, \
        world_tangent


def render_shadow_map(scene: PackedScene, world, light_vp, size: int,
                      object_mask, skin_palette=None, morph_weights=None,
                      with_stats: bool = False, tris=None):
    """Depth-only raster from the light (kernel B1), both faces kept,
    with the wide 2x8 bin window that ortho shadow views need.  tris: an
    index tensor of the only triangles to set up and bin (the depth is
    the same as with every triangle and the others masked off).
    -> depth (size, size) [, raster stats]."""
    setup = shadow_setup(scene, world, light_vp, size, object_mask,
                         skin_palette, morph_weights, tris)
    depth, _tri, stats = rasterize_binned(setup, size, size, span_w=2,
                                          span_h=8, with_stats=True)
    return (depth, stats) if with_stats else depth


def shadow_setup(scene: PackedScene, world, light_vp, size: int,
                 object_mask, skin_palette=None, morph_weights=None,
                 tris=None):
    """Triangle setup of a depth-only light view (both faces kept) of
    every triangle, or of the triangles `tris` only."""
    world_pos = world_positions(scene, world, skin_palette, morph_weights)
    lv = torch.as_tensor(np.asarray(light_vp, np.float32),
                         device=world_pos.device)
    indices, tri_object = scene.indices, scene.tri_object
    if tris is not None:
        indices, tri_object = indices[tris], tri_object[tris]
    setup = R.setup_triangles(project(world_pos, lv), indices, size,
                              size, cull_mode=R.CULL_NONE)
    return setup._replace(valid=setup.valid & object_mask[tri_object.long()])


# ---------------------------------------------------------------------------
# G-buffer: raster + resolve (B2), material fetch (B3)
# ---------------------------------------------------------------------------

def _normalize(v, eps=1e-20):
    return v / torch.sqrt((v * v).sum(-1).clamp_min(eps))[..., None]


def material_shade_tail(scene, pos, nrm, tan, uv, duvdx, duvdy,
                         base_factor, mr_factor, bundle_id,
                         emissive_factor, covered, lod_bias, prev_pos=None,
                         textures: bool = True):
    """Texture fetch (kernel B3) + normal mapping -> surf dict."""
    with span("surface.material"):
        if not textures:
            emissive = (emissive_factor if scene.has_emissive
                        else torch.zeros_like(base_factor[..., :3]))
            out = {"pos": pos, "normal": _normalize(nrm),
                   "base_color": base_factor[..., :3],
                   "metallic": mr_factor[..., 0],
                   "roughness": mr_factor[..., 1],
                   "emissive": emissive, "covered": covered,
                   "alpha": base_factor[..., 3]}
            if prev_pos is not None:
                out["prev_pos"] = prev_pos
            return out
        lod = material_lod(scene, duvdx, duvdy, lod_bias)
        bnd = torch.where(covered, bundle_id, torch.full_like(bundle_id, -1))
        tex = sample_lod(scene.bundles, bnd, uv[..., 0], uv[..., 1], lod,
                         MATERIAL_CHANNELS)
        base_tex = tex[..., 0:4]
        base_color = base_factor[..., :3] * base_tex[..., :3]
        if scene.has_mr_textures:
            metallic = mr_factor[..., 0] * tex[..., 5]
            roughness = mr_factor[..., 1] * tex[..., 4]
        else:
            metallic = mr_factor[..., 0]
            roughness = mr_factor[..., 1]
        n = _normalize(nrm)
        if scene.has_normal_maps:
            t3 = _normalize(tan[..., :3])
            b = torch.cross(n, t3, dim=-1) * tan[..., 3:4]
            tn = tex[..., 6:9] * 2.0 - 1.0
            n = _normalize(tn[..., 0:1] * t3 + tn[..., 1:2] * b
                           + tn[..., 2:3] * n)
        if scene.has_emissive:
            emissive = emissive_factor * tex[..., 9:12]
        else:
            emissive = torch.zeros_like(base_color)
        out = {"pos": pos, "normal": n, "base_color": base_color,
               "metallic": metallic, "roughness": roughness,
               "emissive": emissive, "covered": covered,
               "alpha": base_factor[..., 3] * base_tex[..., 3]}
        if prev_pos is not None:
            out["prev_pos"] = prev_pos
        return out


def _resolve_surface(scene, setup, world_pos, world_normal, world_tangent,
                     width, height, lod_bias, prev_world_pos, max_visible,
                     material_textures):
    with span("raster.setup"):
        extra = build_resolve_extra(scene, world_pos, world_normal,
                                    world_tangent, prev_world_pos)
    span_w, span_h = bin_window(width, height)
    planes, stats = rasterize_resolve(
        setup, extra, width, height, span_w=span_w, span_h=span_h,
        has_prev=prev_world_pos is not None, max_visible=max_visible,
        with_stats=True)

    def ch(base, n):
        return planes[base:base + n].movedim(0, -1)

    covered = planes[PLANE_COVERED] > 0.5
    surf = material_shade_tail(
        scene, pos=ch(PLANE_POS, 3), nrm=ch(PLANE_NRM, 3),
        tan=ch(PLANE_TAN, 4), uv=ch(PLANE_UV, 2),
        duvdx=ch(PLANE_DUVDX, 2), duvdy=ch(PLANE_DUVDY, 2),
        base_factor=ch(PLANE_BASE, 4), mr_factor=ch(PLANE_MR, 2),
        bundle_id=planes[PLANE_BUNDLE].to(torch.int32),
        emissive_factor=ch(PLANE_EMISSIVE, 3), covered=covered,
        lod_bias=lod_bias,
        prev_pos=(ch(PLANE_PREV, 3) if prev_world_pos is not None
                  else None),
        textures=material_textures)
    return surf, planes[PLANE_DEPTH], stats


def fused_raster_surface(scene: PackedScene, clip, object_mask,
                         world_pos, world_normal, world_tangent,
                         width: int, height: int, lod_bias: float = 0.0,
                         prev_world_pos=None,
                         max_visible: int | None = None,
                         material_textures: bool = True):
    """Raster + resolve (B2) + material fetch (B3) -> (surf, depth,
    raster stats)."""
    with span("raster.setup"):
        setup = R.setup_triangles(clip, scene.indices, width, height)
        setup = setup._replace(
            valid=setup.valid & object_mask[scene.tri_object.long()])
    return _resolve_surface(scene, setup, world_pos, world_normal,
                            world_tangent, width, height, lod_bias,
                            prev_world_pos, max_visible, material_textures)


def rasterize_scene(scene: PackedScene, clip, object_mask, width: int,
                    height: int, cull_mode: int = R.CULL_BACK):
    """Setup + rasterize_objects -> (setup, depth, tri, raster stats):
    the visibility buffer of the classic route."""
    return rasterize_objects(
        scene, R.setup_triangles(clip, scene.indices, width, height,
                                 cull_mode=cull_mode),
        object_mask, width, height)


def rasterize_objects(scene: PackedScene, setup, object_mask, width: int,
                      height: int):
    """Per-object visibility + kernel B1 (its plain version on CPU
    tensors) over a view's triangle setup -> (setup masked to the
    objects, depth, tri, raster stats), with no triangle dropped (B1
    over triangle chunks, raster_dispatch.rasterize_binned_exact)."""
    setup = setup._replace(
        valid=setup.valid & object_mask[scene.tri_object.long()])
    return (setup, *rasterize_binned_exact(setup, width, height))


def surface_attributes(scene: PackedScene, setup, tri, world_pos,
                       world_normal, world_tangent, width: int, height: int,
                       lod_bias: float = 0.0, prev_world_pos=None,
                       material_textures: bool = True):
    """Visibility-buffer resolve of the classic route: every pixel
    gathers its triangle's packed row (adjugate, offset, the corners'
    attributes, material factors), interpolates perspective-correct with
    analytic screen derivatives, then the material fetch (kernel B3) and
    normal mapping.  Uncovered pixels take triangle 0's extrapolated
    attributes (t = max(tri, 0)), as the reference's classic resolve
    does; their `covered` is False.  -> surf dict [+ prev_pos]."""
    dev = world_pos.device
    px, py = R.pixel_centers(width, height, dev)
    covered = tri >= 0
    T_ = scene.indices.shape[0]
    attrs = [world_pos, world_normal, world_tangent, scene.uvs]    # 12
    if prev_world_pos is not None:
        attrs.append(prev_world_pos)                               # +3
    vattrs = torch.cat(attrs, dim=1)                               # (V, A)
    A = vattrs.shape[1]
    corner = vattrs[scene.indices.long()].reshape(T_, 3 * A)
    mat = scene.tri_material.long()
    tri_pack = torch.cat([
        setup.adj.reshape(T_, 9), setup.offset, corner,
        scene.mat_base_color[mat], scene.mat_mr[mat],
        scene.mat_bundle[mat].to(torch.float32)[:, None],
        scene.mat_emissive[mat]], dim=1)                   # (T, 21 + 3A)
    row = tri_pack[tri.clamp_min(0).long()]                # (H, W, 21 + 3A)
    adj = row[..., 0:9].reshape(row.shape[:-1] + (3, 3))
    off = row[..., 9:11]
    m0 = 11 + 3 * A
    av = row[..., 11:m0].reshape(row.shape[:-1] + (3, A))

    rx = (px - off[..., 0])[..., None]
    ry = (py - off[..., 1])[..., None]
    lam = adj[..., 0] * rx + adj[..., 1] * ry + adj[..., 2]
    D = lam.sum(-1)
    Dx = adj[..., 0].sum(-1)
    Dy = adj[..., 1].sum(-1)
    N = (av * lam[..., None]).sum(-2)
    Nx = (av * adj[..., 0][..., None]).sum(-2)
    Ny = (av * adj[..., 1][..., None]).sum(-2)
    D = torch.where(D.abs() < 1e-20, torch.full_like(D, 1e-20), D)[..., None]
    vals = N / D
    ddx = (Nx - vals * Dx[..., None]) / D
    ddy = (Ny - vals * Dy[..., None]) / D
    # uv as two contiguous planes: B3 reads u and v as rows
    uv = vals[..., 10:12].movedim(-1, 0).contiguous().movedim(0, -1)
    return material_shade_tail(
        scene, pos=vals[..., 0:3], nrm=vals[..., 3:6], tan=vals[..., 6:10],
        uv=uv, duvdx=ddx[..., 10:12], duvdy=ddy[..., 10:12],
        base_factor=row[..., m0:m0 + 4], mr_factor=row[..., m0 + 4:m0 + 6],
        bundle_id=row[..., m0 + 6].to(torch.int32),
        emissive_factor=row[..., m0 + 7:m0 + 10], covered=covered,
        lod_bias=lod_bias,
        prev_pos=vals[..., 12:15] if prev_world_pos is not None else None,
        textures=material_textures)


def _safe_w(w):
    """|w| floored at 1e-12, keeping w's sign (w = 0 counts as +)."""
    return w.abs().clamp_min(1e-12) * torch.sign(
        torch.where(w == 0, torch.ones_like(w), w))


def motion_vectors(prev_pos, covered, depth, prev_vp_uv, cam_reproj,
                   width: int, height: int):
    """Per-pixel motion vectors mv = uv_cur - uv_prev (reconstruct_mv).

    Covered pixels reproject the surface's last-frame world position
    (resolved through B2's PLANE_PREV) by the previous un-jittered
    view-proj; background pixels reproject the depth buffer by the camera
    alone.  prev_vp_uv: (4, 4) uv_remap @ prev view-proj; cam_reproj:
    (4, 4) TemporalJitter.reproject_matrix()."""
    uu, vv = uv_grid(height, width, depth.device)
    uv = torch.stack([uu, vv], dim=-1)
    m = prev_vp_uv
    xy = prev_pos @ m[:2, :3].T + m[:2, 3]
    w = prev_pos @ m[3, :3] + m[3, 3]
    uv_obj = xy / _safe_w(w)[..., None]
    ndc = torch.cat([2 * uv - 1.0, depth[..., None],
                     torch.ones_like(depth)[..., None]], dim=-1)
    rp = ndc @ cam_reproj.T
    uv_cam = rp[..., :2] / _safe_w(rp[..., 3:4])
    return uv - torch.where(covered[..., None], uv_obj, uv_cam)


# ---------------------------------------------------------------------------
# Lighting: gather products + kernel B4
# ---------------------------------------------------------------------------

def compute_shadow_term(pos, covered, shadow_map, shadow_uv_mat,
                        pcf_wide: bool = False, shadow_tiled: bool = False,
                        shadow_half_res: bool = False):
    """Directional shadow term per pixel, in the reference's order of
    checks.  (S, S, 2) VSM moments: the tiled route (kernel B3T, half-res
    term) when shadow_tiled, else the per-pixel classic route.  (C, S, S)
    cascades with (C, 4, 4) uv transforms: the cascade blend, at full
    resolution whatever shadow_half_res says.  (S, S) depth: 2x2 PCF, or
    the 6x6 windowed kernel when pcf_wide, at half res + a bilinear
    upsample when asked and the frame is even-sized and >= 64 rows."""
    if shadow_map is None:
        return 1.0
    if shadow_map.dim() == 3 and shadow_map.shape[-1] == 2:
        if shadow_tiled:
            return sample_vsm_shadow_tiled(shadow_map, shadow_uv_mat, pos,
                                           covered)
        return sample_vsm_shadow(shadow_map, shadow_uv_mat, pos)
    if shadow_map.dim() == 3:
        return sample_cascaded_shadow(shadow_map, shadow_uv_mat, pos,
                                      wide=pcf_wide)
    H, W = pos.shape[:2]
    if shadow_half_res and H % 2 == 0 and W % 2 == 0 and H >= 64:
        th = sample_directional_shadow(shadow_map, shadow_uv_mat,
                                       pos[::2, ::2], wide=pcf_wide)
        return resize_bilinear(th[..., None], H, W)[..., 0]
    return sample_directional_shadow(shadow_map, shadow_uv_mat, pos,
                                     wide=pcf_wide)


def reflection(surf, camera_pos, levels: int):
    """Reflected view direction and prefiltered-env lod per pixel."""
    n = surf["normal"]
    v = camera_pos - surf["pos"]
    v = v / torch.sqrt((v * v).sum(-1, keepdim=True).clamp_min(1e-20))
    nov = (n * v).sum(-1).clamp(0.0, 1.0)
    return 2.0 * nov[..., None] * n - v, surf["roughness"] * (levels - 1.0)


def material_lod(scene, duvdx, duvdy, lod_bias: float):
    """Material mip lod from the analytic UV derivative planes."""
    S = scene.bundles.shape[2]
    return lod_from_derivs(duvdx[..., 0], duvdx[..., 1], duvdy[..., 0],
                           duvdy[..., 1], S, S, bias=lod_bias)


def half_res_inputs(*planes):
    """Every other pixel of each (H, W, ...) plane, copied at half size:
    B3 reads rows of contiguous elements (ops/tile_sampler.row_stride)."""
    return [t[::2, ::2].contiguous() for t in planes]


def half_res_environment(strips, refl, lod, height: int, width: int,
                         covered=None):
    """The specular environment fetched (B3) at every other pixel, then
    upsampled bilinearly to (height, width); uncovered half-res pixels
    fetch nothing and stay 0, and the upsample blends them into their
    neighbours, as in the reference."""
    if covered is None:
        refl, lod = half_res_inputs(refl, lod)
    else:
        refl, lod, covered = half_res_inputs(refl, lod, covered)
    return resize_bilinear(sample_environment(strips, refl, lod,
                                              covered=covered),
                           height, width)


def compute_env_products(surf, params, env, width: int, height: int,
                         background, vol_diffuse=None):
    """(irradiance/pi, specular env (B3), background) per pixel.  Under
    the analytic sky, env["tiled"] (default on) picks the reference's
    route: its tile sampler's fetch, or its untiled route, the fetch at
    every other pixel and a bilinear upsample.  env["half_res"]
    (envSpecularHalfRes) takes the tiled fetch at every other pixel too,
    upsampled, where the reference does: 3-D normals of even height and
    width; the analytic sky background stays at full resolution.
    vol_diffuse ({"volumes", "fallback"}): the baked probe volumes give
    the irradiance instead of the SH sky (their probes carry the 1/pi)."""
    n = surf["normal"]
    pos = surf["pos"]
    cov = surf["covered"]
    cam = params["camera_pos"]
    if vol_diffuse is not None:
        irr = sample_volumetric_diffuse(vol_diffuse["volumes"], pos, n,
                                        vol_diffuse["fallback"])
    else:
        irr = eval_sh9(env["sh"], n).clamp_min(0.0) / math.pi
    refl, lod = reflection(surf, cam, env["levels"])
    half = (bool(env.get("half_res")) and n.dim() == 3
            and n.shape[0] % 2 == 0 and n.shape[1] % 2 == 0)
    if background is None and width and height:
        px, py = R.pixel_centers(width, height, pos.device)
        ndc = torch.stack([2 * (px + 0.0) / width - 1,
                           2 * (py + 0.0) / height - 1,
                           torch.full_like(px, 0.5),
                           torch.ones_like(px)], dim=-1)
        wp = ndc @ params["inv_view_proj"].T
        w = wp[..., 3:4]
        view_dirs = wp[..., :3] / torch.where(
            w.abs() < 1e-20, torch.full_like(w, 1e-20), w) - cam
        if env.get("sky_params"):
            background = analytic_sky(view_dirs, **env["sky_params"])
            if not env.get("tiled", True):
                spec_env = half_res_environment(env["strips"], refl, lod,
                                                height, width)
            elif half:
                spec_env = half_res_environment(env["strips"], refl, lod,
                                                height, width, covered=cov)
            else:
                spec_env = sample_environment(env["strips"], refl, lod,
                                              covered=cov)
        else:
            dirs = torch.where(cov[..., None], refl, view_dirs)
            lod = torch.where(cov, lod, torch.zeros_like(lod))
            spec_env = background = sample_environment(env["strips"], dirs,
                                                       lod)
    elif half and env.get("tiled", True):
        spec_env = half_res_environment(env["strips"], refl, lod, n.shape[0],
                                        n.shape[1], covered=cov)
    else:
        spec_env = sample_environment(env["strips"], refl, lod, covered=cov)
    if background is None:
        background = torch.zeros(3, device=pos.device)
    return irr, spec_env, torch.broadcast_to(background, n.shape)


def shade_surface_fused(surf: dict, params, **kw):
    """The deferred lighting pass through kernel B4 -> (H, W, 3)."""
    args, kernel_kw = shade_inputs(surf, params, **kw)
    with span("light.shade"):
        return shade_planes_fused(*args, **kernel_kw).movedim(0, -1)


def shade_inputs(surf: dict, params, shadow_map=None, shadow_uv_mat=None,
                 lights=None, z_masks=None, tile_masks=None, width: int = 0,
                 height: int = 0, background=None, z_near: float = 0.1,
                 z_far: float = 1000.0, env=None, cluster_shadows=None,
                 ao=None, pcf_wide: bool = False, shadow_tiled: bool = False,
                 shadow_half_res: bool = False, view=None,
                 vol_diffuse=None):
    """Kernel B4's inputs for a surf dict: the gather-bound products
    (shadow term, env products through B3, top-K atlas terms) stacked
    with the G-buffer into padded planes, the light table, tile masks
    and uniforms.  -> (positional args, keyword args) of
    ops/shade_fused.shade_planes_fused."""
    dev = surf["pos"].device
    if view is None and lights is not None:
        view = params["view"]
    z_slices = z_masks.shape[0] if z_masks is not None else 32
    H, W = surf["metallic"].shape
    pos = surf["pos"]
    with span("light.sun_shadow"):
        shadow_term = compute_shadow_term(pos, surf["covered"], shadow_map,
                                          shadow_uv_mat, pcf_wide,
                                          shadow_tiled, shadow_half_res)
        shadow_term = torch.broadcast_to(
            upload(shadow_term, dtype=torch.float32, device=dev), (H, W))
    has_env = env is not None
    if has_env:
        with span("light.env"):
            irr, spec_env, bg = compute_env_products(
                surf, params, env, width, height, background, vol_diffuse)
    else:
        irr = spec_env = torch.zeros((H, W, 3), device=dev)
        bg = torch.broadcast_to(
            torch.zeros(3, device=dev) if background is None
            else torch.as_tensor(background, dtype=torch.float32,
                                 device=dev), (H, W, 3))

    has_lights = lights is not None
    slot_planes = []
    if has_lights and cluster_shadows is not None:
        with span("light.point_shadows"):
            cs = cluster_shadows
            half = bool(cs.get("half_res", False))
            tpos = pos[::2, ::2] if half else pos
            log_ratio = math.log(z_far / z_near)
            vz = -(tpos @ view[2, :3] + view[2, 3])
            s = (torch.log(vz.clamp_min(z_near) / z_near) / log_ratio
                 * z_slices).clamp(0, z_slices - 1).to(torch.int64)
            tiled = tile_masks.repeat_interleave(CLUSTER_TILE, 0) \
                .repeat_interleave(CLUSTER_TILE, 1)[:H, :W]
            if half:
                tiled = tiled[::2, ::2]
            pixel_masks = z_masks[s] & tiled
            slots, terms = topk_shadow_terms(
                cs["atlas_flat"], cs["vps_np"], cs["size"],
                int(cs["num_lights"]), cs["light_slice_np"],
                cs["light_kind_np"], cs["light_pos_np"], pixel_masks, tpos,
                k=cs.get("k", 4), bias=cs.get("bias", 2e-3))
            if half:
                slots = slots.repeat_interleave(2, 1).repeat_interleave(
                    2, 2)[:, :H, :W]
                terms = terms.repeat_interleave(2, 1).repeat_interleave(
                    2, 2)[:, :H, :W]
            k_shadow = slots.shape[0]
            slot_planes = [slots[j].to(torch.float32)
                           for j in range(k_shadow)] \
                + [terms[j] for j in range(k_shadow)]
    k_shadow = len(slot_planes) // 2

    with span("light.shade"):
        has_ao = ao is not None
        zero = torch.zeros((H, W), device=dev)
        planes = [
            surf["base_color"][..., 0], surf["base_color"][..., 1],
            surf["base_color"][..., 2],
            surf["normal"][..., 0], surf["normal"][..., 1],
            surf["normal"][..., 2],
            surf["metallic"], surf["roughness"],
            pos[..., 0], pos[..., 1], pos[..., 2],
            surf["emissive"][..., 0], surf["emissive"][..., 1],
            surf["emissive"][..., 2],
            surf["covered"].to(torch.float32),
            shadow_term,
            spec_env[..., 0], spec_env[..., 1], spec_env[..., 2],
            bg[..., 0], bg[..., 1], bg[..., 2],
            ao if has_ao else zero,
            irr[..., 0], irr[..., 1], irr[..., 2],
        ] + slot_planes
        assert len(planes) == P_FIXED + 2 * k_shadow
        ph = -(-H // 32) * 32
        pw = -(-W // 128) * 128
        stacked = torch.zeros((len(planes), ph, pw), dtype=torch.float32,
                              device=dev)
        stacked[:, :H, :W] = torch.stack([p.to(torch.float32) for p in planes])

        uni = torch.zeros((8, 128), dtype=torch.float32, device=dev)
        uni[0, 0:3] = params["camera_pos"]
        uni[0, 3:6] = params["sun_dir"]
        uni[1, 0:3] = params["sun_color"]
        tmh = -(-ph // CLUSTER_TILE)
        tmw = pw // CLUSTER_TILE
        tm = torch.zeros((tmh, tmw), dtype=torch.int32, device=dev)
        if has_lights:
            uni[0, 6].fill_(float(lights.count))   # an argument, no copy
            uni[0, 9:13] = view[2]
            ltbl = fused_light_table(lights, view, z_near, z_far, z_slices)
            src = tile_masks[..., 0]
            h_, w_ = min(tmh, src.shape[0]), min(tmw, src.shape[1])
            tm[:h_, :w_] = src[:h_, :w_]
        else:
            ltbl = torch.zeros((1, 128), dtype=torch.float32, device=dev)
        return (stacked, ltbl, tm, uni, H, W), dict(
            k_shadow=k_shadow, has_env=has_env, has_lights=has_lights,
            has_ao=has_ao, ambient=not has_env)


def transparent_composite(scene: PackedScene, clip, opaque_depth,
                          opaque_hdr, transparent_mask, params,
                          width: int, height: int, world_pos,
                          world_normal, world_tangent, **light_kw):
    """Transparent queue: blended materials raster (B2, both faces) and
    resolve (B3) after opaque lighting, depth-tested against the opaque
    depth without writing it, forward-shaded (B4) and alpha-blended over
    the lit frame.  One visibility layer: overlapping transparent
    surfaces resolve to the nearest, like the reference."""
    setup = R.setup_triangles(clip, scene.indices, width, height,
                              cull_mode=R.CULL_NONE)
    setup = setup._replace(
        valid=setup.valid & transparent_mask[scene.tri_object.long()])
    surf, depth, _stats = _resolve_surface(
        scene, setup, world_pos, world_normal, world_tangent, width,
        height, 0.0, None, None, True)
    visible = surf["covered"] & (depth > opaque_depth)
    surf["covered"] = visible
    color = shade_surface_fused(
        surf, params, width=width, height=height,
        background=torch.zeros(3, device=opaque_hdr.device), **light_kw)
    a = torch.where(visible, surf["alpha"],
                    torch.zeros_like(surf["alpha"]))[..., None]
    return opaque_hdr * (1.0 - a) + color * a
