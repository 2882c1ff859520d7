"""Scene — SoA node hierarchy + visibility (copy of the parts of
granite_tpu/scene/scene.py the port uses; reference: renderer/scene.hpp).

Nodes are SoA arrays (parent, TRS); world transforms are updated level
by level with batched matmuls.  Renderables are SoA too (node, mesh,
flags, local AABB), and every gather query is one vectorized frustum
cull over all AABBs; RENDERABLE_DYNAMIC splits the shadow casters into
the cached static set and the per-frame dynamic set (skinned meshes).
Morph-target weights ride node_morph_weights, written by the animation
system.  Volumetric decals are unit boxes on nodes
(create_volumetric_decal, gather_visible_volumetric_decals), and so are
volumetric fog regions (create_volumetric_fog_region, with an optional
density grid) and diffuse GI volumes (create_volumetric_diffuse_light,
with their probe resolution).  Like the original, the Scene is built on
an ECS EntityPool (scene/ecs.py): every node, renderable, decal, fog
region and diffuse volume is an entity whose components carry its row
indices (TransformComponent, RenderableComponent + BoundedComponent and
the queue tags, VolumetricDecalComponent,
VolumetricDiffuseLightComponent), so EntityGroup queries work against
the scene; no frame query reads the pool.  add_renderable returns the
row (the original wraps it in a RenderableHandle).
tests/test_torch_host_copies.py and tests/test_torch_ecs.py hold this
copy equal to the original.
"""

from __future__ import annotations

import numpy as np

from ..math.aabb import transform_aabbs
from ..math.frustum import frustum_cull
from ..math.transforms import compose_trs_batch
from .ecs import EntityPool

# -- scene component types (the reference's ecs component classes backing
# renderer/scene.hpp:113: RenderInfoComponent, RenderableComponent,
# OpaqueComponent/TransparentComponent/CastsStaticShadowComponent tag
# types, ecs.hpp:130/209).  Hot per-frame data stays in the Scene SoA;
# these components carry IDENTITY (row indices) so EntityGroup queries
# work against the real scene.


class TransformComponent:
    __slots__ = ("node",)

    def __init__(self, node: int):
        self.node = node


class RenderableComponent:
    __slots__ = ("row", "mesh")

    def __init__(self, row: int, mesh: int):
        self.row = row
        self.mesh = mesh


class BoundedComponent:
    __slots__ = ("row",)

    def __init__(self, row: int):
        self.row = row


class OpaqueComponent:
    __slots__ = ()


class TransparentComponent:
    __slots__ = ()


class CastsShadowComponent:
    __slots__ = ()


class DynamicComponent:
    __slots__ = ()


class VolumetricDiffuseLightComponent:
    """render_components.hpp VolumetricDiffuseLightComponent: a probe
    grid volume over the node's unit box."""

    def __init__(self, index: int):
        self.index = index


class VolumetricDecalComponent:
    """renderer/render_components.hpp VolumetricDecalComponent: the
    marker the reference clusterer's decal gather queries."""

    def __init__(self, index: int):
        self.index = index


RENDERABLE_OPAQUE = 1 << 0
RENDERABLE_TRANSPARENT = 1 << 1
RENDERABLE_CASTS_SHADOW = 1 << 2
RENDERABLE_DYNAMIC = 1 << 3


class Scene:
    def __init__(self, capacity_nodes: int = 0):
        cap = max(capacity_nodes, 64)
        self._node_cap = cap
        self.parent = np.full(cap, -1, np.int32)
        self.translation = np.zeros((cap, 3), np.float32)
        self.rotation = np.tile(np.array([1, 0, 0, 0], np.float32),
                                (cap, 1))
        self.scale = np.ones((cap, 3), np.float32)
        self.world = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        self._n_nodes = capacity_nodes
        self._levels_dirty = True
        self._levels: list[np.ndarray] = []
        # renderables SoA
        self._n_renderables = 0
        self.r_node = np.zeros(0, np.int32)
        self.r_mesh = np.zeros(0, np.int32)
        self.r_flags = np.zeros(0, np.int32)
        self.r_aabb_min = np.zeros((0, 3), np.float32)
        self.r_aabb_max = np.zeros((0, 3), np.float32)
        self.r_world_min = np.zeros((0, 3), np.float32)
        self.r_world_max = np.zeros((0, 3), np.float32)
        # Morph-target weights per node (sparse: only morphing nodes).
        self.node_morph_weights: dict[int, np.ndarray] = {}
        # ECS substrate: entities/groups back scene identity (the
        # reference's Scene is built ON the ecs EntityPool; here the
        # pool indexes into the SoA rows above).
        self.entity_pool = EntityPool()
        self.node_entity: list = []
        self.renderable_entity: list = []
        # Volumetric decals (scene.cpp:1059 create_volumetric_decal):
        # each is a unit box [-0.5, 0.5]^3 on a node, with a texture id
        # resolved by the app's decal strip array.
        self.decal_node: list[int] = []
        self.decal_tex: list[int] = []
        self.decal_entity: list = []
        # Volumetric diffuse GI volumes (scene.cpp create_volumetric_
        # diffuse_light): (node, (X, Y, Z) probe resolution).
        self.diffuse_volume_node: list[int] = []
        self.diffuse_volume_res: list[tuple] = []
        self.diffuse_volume_entity: list = []
        # Volumetric fog regions (scene.cpp create_volumetric_fog_region,
        # lights/volumetric_fog_region.hpp): unit boxes with an optional
        # (D, H, W) density grid.
        self.fog_region_node: list[int] = []
        self.fog_region_volume: list = []
        self.fog_region_entity: list = []

    # -- node management --------------------------------------------------------
    def _grow_nodes(self) -> None:
        """Amortized capacity doubling."""
        cap = max(self._node_cap * 2, 64)
        self._node_cap = cap

        def grow(a, fill):
            out = np.empty((cap,) + a.shape[1:], a.dtype)
            out[:len(a)] = a
            out[len(a):] = fill
            return out
        self.parent = grow(self.parent, -1)
        self.translation = grow(self.translation, 0.0)
        self.rotation = grow(self.rotation,
                             np.array([1, 0, 0, 0], np.float32))
        self.scale = grow(self.scale, 1.0)
        self.world = grow(self.world, np.eye(4, dtype=np.float32))

    def create_node(self, parent: int = -1, translation=None, rotation=None,
                    scale=None) -> int:
        idx = self._n_nodes
        if idx >= self._node_cap:
            self._grow_nodes()
        self._n_nodes += 1
        self.parent[idx] = parent
        self.translation[idx] = 0.0 if translation is None else \
            np.asarray(translation, np.float32)
        self.rotation[idx] = (1, 0, 0, 0) if rotation is None else \
            np.asarray(rotation, np.float32)
        self.scale[idx] = 1.0 if scale is None else \
            np.asarray(scale, np.float32)
        self.world[idx] = np.eye(4, dtype=np.float32)
        self._levels_dirty = True
        e = self.entity_pool.create_entity()
        e.allocate_component(TransformComponent, idx)
        self.node_entity.append(e)
        return idx

    def set_parent(self, node: int, parent: int) -> None:
        self.parent[node] = parent
        self._levels_dirty = True

    def _rebuild_levels(self) -> None:
        """Group nodes by tree depth for level-ordered batched updates."""
        n = self._n_nodes
        depth = np.zeros(n, np.int32)
        parent = self.parent[:n]
        for _ in range(64):
            new_depth = np.where(parent >= 0, depth[np.maximum(parent, 0)] + 1,
                                 0)
            if np.array_equal(new_depth, depth):
                break
            depth = new_depth
        self._levels = [np.nonzero(depth == d)[0].astype(np.int32)
                        for d in range(int(depth.max()) + 1 if n else 0)]
        self._levels_dirty = False

    def update_transform_tree(self) -> None:
        """Level-ordered batched world-matrix update (scene.hpp:127-130)."""
        n = self._n_nodes
        if n == 0:
            return
        if self._levels_dirty:
            self._rebuild_levels()
        local = compose_trs_batch(self.translation[:n], self.rotation[:n],
                                  self.scale[:n])
        world = self.world
        for level in self._levels:
            p = self.parent[level]
            has_parent = p >= 0
            lw = local[level]
            if has_parent.any():
                pw = world[np.maximum(p, 0)]
                combined = np.matmul(pw, lw)
                world[level] = np.where(has_parent[:, None, None], combined,
                                        lw)
            else:
                world[level] = lw
        self.update_cached_transforms()

    def update_cached_transforms(self) -> None:
        """World-space renderable AABBs in one vectorized pass."""
        if len(self.r_node) == 0:
            return
        w = self.world[self.r_node]
        self.r_world_min, self.r_world_max = transform_aabbs(
            w, self.r_aabb_min, self.r_aabb_max)

    # -- renderables --------------------------------------------------------------
    def add_renderable(self, node: int, mesh: int, flags: int,
                       aabb_min, aabb_max) -> int:
        """Append a renderable; -> its row."""
        n = self._n_renderables
        cap = len(self._r_node_buf) if n else 0
        if n >= cap:
            newcap = max(cap * 2, 64)

            def grow(name, shape, dtype):
                buf = np.zeros((newcap,) + shape, dtype)
                old = getattr(self, name, None)
                if old is not None and len(old):
                    buf[:len(old)] = old
                return buf
            self._r_node_buf = grow("_r_node_buf", (), np.int32)
            self._r_mesh_buf = grow("_r_mesh_buf", (), np.int32)
            self._r_flags_buf = grow("_r_flags_buf", (), np.int32)
            self._r_amin_buf = grow("_r_amin_buf", (3,), np.float32)
            self._r_amax_buf = grow("_r_amax_buf", (3,), np.float32)
            self._r_wmin_buf = grow("_r_wmin_buf", (3,), np.float32)
            self._r_wmax_buf = grow("_r_wmax_buf", (3,), np.float32)
        self._r_node_buf[n] = node
        self._r_mesh_buf[n] = mesh
        self._r_flags_buf[n] = flags
        self._r_amin_buf[n] = np.asarray(aabb_min, np.float32)
        self._r_amax_buf[n] = np.asarray(aabb_max, np.float32)
        self._n_renderables = m = n + 1
        # Public views track the logical length (in-place writes flow
        # through; slicing is O(1)).
        self.r_node = self._r_node_buf[:m]
        self.r_mesh = self._r_mesh_buf[:m]
        self.r_flags = self._r_flags_buf[:m]
        self.r_aabb_min = self._r_amin_buf[:m]
        self.r_aabb_max = self._r_amax_buf[:m]
        self.r_world_min = self._r_wmin_buf[:m]
        self.r_world_max = self._r_wmax_buf[:m]
        e = self.entity_pool.create_entity()
        e.allocate_component(RenderableComponent, n, mesh)
        e.allocate_component(BoundedComponent, n)
        if flags & RENDERABLE_OPAQUE:
            e.allocate_component(OpaqueComponent)
        if flags & RENDERABLE_TRANSPARENT:
            e.allocate_component(TransparentComponent)
        if flags & RENDERABLE_CASTS_SHADOW:
            e.allocate_component(CastsShadowComponent)
        if flags & RENDERABLE_DYNAMIC:
            e.allocate_component(DynamicComponent)
        self.renderable_entity.append(e)
        return n

    # -- volumetric decals (scene.cpp:1059, scene.cpp:400) -----------------------
    def create_volumetric_decal(self, node: int, tex_id: int = 0) -> int:
        """Attach a unit-box decal volume to `node`
        (Scene::create_volumetric_decal).  The node's world transform
        maps the box into the scene; tex_id indexes the app's decal strip
        array."""
        idx = len(self.decal_node)
        self.decal_node.append(node)
        self.decal_tex.append(tex_id)
        e = self.entity_pool.create_entity()
        e.allocate_component(VolumetricDecalComponent, idx)
        e.allocate_component(TransformComponent, node)
        self.decal_entity.append(e)
        return idx

    def create_volumetric_fog_region(self, node: int,
                                     density_volume=None) -> int:
        """Attach a unit-box fog region to `node`
        (Scene::create_volumetric_fog_region).  density_volume: optional
        (D, H, W) float grid sampled in the region's texture space
        (VolumetricFogRegion::set_volume); None = constant 1."""
        idx = len(self.fog_region_node)
        self.fog_region_node.append(node)
        self.fog_region_volume.append(density_volume)
        e = self.entity_pool.create_entity()
        e.allocate_component(TransformComponent, node)
        self.fog_region_entity.append(e)
        return idx

    def create_volumetric_diffuse_light(self, resolution, node: int) -> int:
        """Attach an ambient-cube probe grid volume to `node`
        (Scene::create_volumetric_diffuse_light; the reference viewer
        creates one scaled (32, 8, 32) over the scene,
        scene_viewer_application.cpp:300-309)."""
        idx = len(self.diffuse_volume_node)
        self.diffuse_volume_node.append(node)
        self.diffuse_volume_res.append(tuple(int(r) for r in resolution))
        e = self.entity_pool.create_entity()
        e.allocate_component(VolumetricDiffuseLightComponent, idx)
        e.allocate_component(TransformComponent, node)
        self.diffuse_volume_entity.append(e)
        return idx

    def gather_visible_volumetric_decals(self, frustum) -> np.ndarray:
        """Frustum-visible decal indices
        (Scene::gather_visible_volumetric_decals, scene.cpp:400): world
        AABBs of the transformed unit boxes against the frustum planes."""
        if not self.decal_node:
            return np.zeros(0, np.int32)
        w = self.world[np.asarray(self.decal_node, np.int32)]
        mn, mx = transform_aabbs(
            w, np.full((len(self.decal_node), 3), -0.5, np.float32),
            np.full((len(self.decal_node), 3), 0.5, np.float32))
        vis = frustum_cull(frustum.planes, mn, mx)
        return np.nonzero(vis)[0].astype(np.int32)

    # -- visibility queries (scene.hpp:133-163 gather_visible_*) -----------------
    def _gather(self, planes, flag_mask: int) -> np.ndarray:
        if len(self.r_node) == 0:
            return np.zeros(0, np.int32)
        sel = (self.r_flags & flag_mask) != 0
        vis = frustum_cull(planes, self.r_world_min, self.r_world_max)
        return np.nonzero(sel & vis)[0].astype(np.int32)

    def gather_visible_opaque_renderables(self, frustum) -> np.ndarray:
        return self._gather(frustum.planes, RENDERABLE_OPAQUE)

    def gather_visible_transparent_renderables(self, frustum) -> np.ndarray:
        return self._gather(frustum.planes, RENDERABLE_TRANSPARENT)

    def gather_visible_static_shadow_renderables(self, frustum) -> np.ndarray:
        mask = self._gather(frustum.planes, RENDERABLE_CASTS_SHADOW)
        return mask[(self.r_flags[mask] & RENDERABLE_DYNAMIC) == 0]

    def gather_visible_dynamic_shadow_renderables(self, frustum) -> np.ndarray:
        mask = self._gather(frustum.planes, RENDERABLE_CASTS_SHADOW)
        return mask[(self.r_flags[mask] & RENDERABLE_DYNAMIC) != 0]

    @property
    def num_nodes(self) -> int:
        return self._n_nodes
