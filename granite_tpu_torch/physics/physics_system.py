"""Rigid-body physics system (copy of granite_tpu/physics/physics_system.py;
reference: physics/physics_system.{hpp,cpp}).

The code is the original's, float64 operation order included, so the
trajectories, body states and CollisionEvents are bit-equal to it
(tests/test_torch_physics.py).  Two faults of the original are fixed
here, neither on a path where the two agree:
  * a world point constraint kept its anchor per BODY (an attribute
    named after the body's index), so a second world pin on the same
    body pulled its pivot to the first pin's anchor; each constraint
    keeps its own anchor here;
  * iterate() applied a ForceComponent to its handle's body even after
    remove_body, and so raised on the removed slot (None); the force of
    a removed body is skipped here.

The reference wraps Bullet (btDiscreteDynamicsWorld) — a CPU library —
behind `PhysicsSystem` (physics_system.hpp:147-290): ECS components
(PhysicsComponent/ForceComponent/CollisionMeshComponent), fixed
1/300 s ticks with up-to-20 substeps (physics_system.cpp:31,362),
gravity (0,-9.81,0) (cpp:177), node-transform sync each iterate
(cpp:302-400), CollisionEvents through the EventManager, raycasts,
point constraints, kinematic characters and overlap queries.

TPU-native split: simulation stays on the host (rigid-body counts are
tiny next to pixel work; the device sees only the resulting node
transforms like every other scene update), implemented as an original
impulse-based solver over the GJK/EPA narrowphase in shapes.py instead
of a Bullet port:

  * broadphase: vectorized AABB overlap over numpy SoA bounds;
  * narrowphase: one code path (GJK distance / EPA penetration) for
    every convex pair; planes and static triangle meshes dispatch
    specially;
  * solver: sequential impulses with Baumgarte stabilization, Coulomb
    friction (two tangent rows) and restitution, semi-implicit Euler.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..event.manager import Event, EventManager
from ..math.muglm import quat_mul, quat_normalize, quat_rotate
from .shapes import (Box, Capsule, Cone, ConvexHull, Cylinder, Posed,
                     Shape, Sphere, epa_penetration, gjk_distance,
                     ray_box, ray_convex_trace, ray_sphere,
                     ray_triangles)

PHYSICS_TICK = 1.0 / 300.0           # physics_system.cpp:31
GRAVITY = np.array([0.0, -9.81, 0.0])
SOLVER_ITERS = 10
BAUMGARTE = 0.2
PENETRATION_SLOP = 0.005
RESTITUTION_THRESHOLD = 1.0          # m/s closing speed


class InteractionType(enum.Enum):
    Ghost = 0
    Area = 1
    Static = 2
    Dynamic = 3
    Kinematic = 4


class MeshType(enum.Enum):
    None_ = 0
    ConvexHull = 1
    Cube = 2
    Sphere = 3
    Cone = 4
    Capsule = 5
    Cylinder = 6


INTERACTION_TYPE_STATIC_BIT = 1 << 0
INTERACTION_TYPE_DYNAMIC_BIT = 1 << 1
INTERACTION_TYPE_INVISIBLE_BIT = 1 << 2
INTERACTION_TYPE_KINEMATIC_BIT = 1 << 3
INTERACTION_TYPE_ALL_BITS = 0x7FFFFFFF

_TYPE_BITS = {
    InteractionType.Static: INTERACTION_TYPE_STATIC_BIT,
    InteractionType.Dynamic: INTERACTION_TYPE_DYNAMIC_BIT,
    InteractionType.Kinematic: INTERACTION_TYPE_KINEMATIC_BIT,
    InteractionType.Ghost: INTERACTION_TYPE_INVISIBLE_BIT,
    InteractionType.Area: INTERACTION_TYPE_INVISIBLE_BIT,
}


@dataclass
class MaterialInfo:
    """physics_system.hpp:162-171."""
    type: InteractionType = InteractionType.Dynamic
    mass: float = 1.0
    restitution: float = 0.5
    linear_damping: float = 0.1
    angular_damping: float = 0.1
    friction: float = 0.2
    rolling_friction: float = 0.2
    margin: float = 0.01


@dataclass
class ConvexMeshPart:
    """physics_system.hpp:199-206."""
    type: MeshType = MeshType.None_
    child_node: int | None = None
    index: int = 0
    height: float = 1.0
    radius: float = 1.0


@dataclass
class CollisionMesh:
    """physics_system.hpp:173-186 (SoA triangle soup)."""
    indices: np.ndarray = None          # (T, 3) uint32
    positions: np.ndarray = None        # (V, 3) f32
    margin: float = 0.1


class PhysicsComponent:
    """ECS component carrying the body handle (hpp:46-51)."""

    def __init__(self, handle: "PhysicsHandle"):
        self.handle = handle


class ForceComponent:
    """Per-iterate force/torque (hpp:60-65)."""

    def __init__(self, linear_force=(0, 0, 0), torque=(0, 0, 0)):
        self.linear_force = np.asarray(linear_force, np.float64)
        self.torque = np.asarray(torque, np.float64)


class CollisionMeshComponent:
    def __init__(self, mesh: CollisionMesh):
        self.mesh = mesh


class CollisionEvent(Event):
    """hpp:86-136 — dispatched for each NEW contact pair."""

    def __init__(self, entity0, entity1, object0, object1,
                 world_point, normal):
        self.entity0 = entity0
        self.entity1 = entity1
        self.object0 = object0
        self.object1 = object1
        self.world_point = np.asarray(world_point)
        self.normal = np.asarray(normal)

    def get_first_entity(self):
        return self.entity0

    def get_second_entity(self):
        return self.entity1

    def get_first_handle(self):
        return self.object0

    def get_second_handle(self):
        return self.object1

    def get_world_contact(self):
        return self.world_point

    def get_world_normal(self):
        return self.normal


@dataclass
class RaycastResult:
    """hpp:138-145."""
    entity: object = None
    handle: "PhysicsHandle" = None
    world_pos: np.ndarray = None
    world_normal: np.ndarray = None
    t: float = np.inf

    def __bool__(self):
        return self.handle is not None


class PhysicsHandle:
    """Opaque body handle (the reference pools these; hpp:44)."""

    __slots__ = ("index", "system", "entity", "node", "alive")

    def __init__(self, index: int, system: "PhysicsSystem"):
        self.index = index
        self.system = system
        self.entity = None
        self.node = None
        self.alive = True


@dataclass
class _Body:
    shape: object                       # Shape | list[(Shape,off,rot)] |
    #                                     ("plane", vec4) | ("mesh", id)
    itype: InteractionType
    mat: MaterialInfo
    pos: np.ndarray
    rot: np.ndarray                     # quat (w,x,y,z)
    linvel: np.ndarray = field(default_factory=lambda: np.zeros(3))
    angvel: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inv_mass: float = 0.0
    inv_inertia_local: np.ndarray = field(
        default_factory=lambda: np.zeros(3))
    force: np.ndarray = field(default_factory=lambda: np.zeros(3))
    torque: np.ndarray = field(default_factory=lambda: np.zeros(3))
    node: int | None = None
    copy_from_node: bool = False        # kinematic/ghost follow the node


def _quat_from_omega(q, w, dt):
    dq = 0.5 * dt * np.array([-(w[0] * q[1] + w[1] * q[2] + w[2] * q[3]),
                              w[0] * q[0] + w[1] * q[3] - w[2] * q[2],
                              w[1] * q[0] + w[2] * q[1] - w[0] * q[3],
                              w[2] * q[0] + w[0] * q[2] - w[1] * q[1]])
    return quat_normalize(q + dq)


def _rot_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class _Contact:
    __slots__ = ("ia", "ib", "point", "normal", "depth", "jn", "jt")

    def __init__(self, ia, ib, point, normal, depth):
        self.ia = ia
        self.ib = ib
        self.point = np.asarray(point)
        self.normal = np.asarray(normal)     # points from b toward a
        self.depth = depth
        self.jn = 0.0


class PhysicsSystem:
    """physics_system.hpp:147 — the world."""

    def __init__(self):
        self._bodies: list[_Body | None] = []
        self._handles: list[PhysicsHandle] = []
        self._meshes: list[CollisionMesh] = []
        self._mesh_aabbs: list[np.ndarray] = []
        self._constraints: list = []      # (ha, hb|None, pivot_a, pivot_b)
        self._anchors: dict = {}          # constraint -> world anchor
        self._characters: list = []
        self._accum = 0.0
        self._prev_pairs: set = set()
        self.scene = None
        self.entity_pool = None

    # -- scene / ECS ------------------------------------------------------
    def set_scene(self, scene) -> None:
        self.scene = scene

    def set_entity_pool(self, pool) -> None:
        """ECS pool whose (PhysicsComponent, ForceComponent) group gets
        force application each iterate (physics_system.cpp:302-320)."""
        self.entity_pool = pool

    # -- registration -----------------------------------------------------
    def register_collision_mesh(self, mesh: CollisionMesh) -> int:
        tris = np.asarray(mesh.positions, np.float64)[
            np.asarray(mesh.indices, np.int64)]        # (T, 3, 3)
        self._meshes.append(mesh)
        self._mesh_aabbs.append(
            np.stack([tris.min(axis=(0, 1)), tris.max(axis=(0, 1))]))
        mesh._tris = tris
        mesh._tri_lo = tris.min(axis=1)
        mesh._tri_hi = tris.max(axis=1)
        return len(self._meshes) - 1

    def _node_trs(self, node):
        if node is None or self.scene is None:
            return np.zeros(3), np.array([1.0, 0, 0, 0]), np.ones(3)
        return (self.scene.translation[node].astype(np.float64),
                self.scene.rotation[node].astype(np.float64),
                self.scene.scale[node].astype(np.float64))

    def _create_shape(self, part: ConvexMeshPart, scale) -> Shape:
        """physics_system.cpp create_shape: MeshType -> bt shape."""
        if part.type == MeshType.Sphere:
            return Sphere(part.radius * float(np.max(scale)))
        if part.type == MeshType.Cube:
            return Box(scale)
        if part.type == MeshType.Cone:
            return Cone(part.radius * scale[0], 0.5 * part.height * scale[1])
        if part.type == MeshType.Capsule:
            return Capsule(part.radius * scale[0],
                           0.5 * part.height * scale[1])
        if part.type == MeshType.Cylinder:
            return Cylinder(part.radius * scale[0],
                            0.5 * part.height * scale[1])
        raise ValueError(f"unsupported part type {part.type}")

    def _add_body(self, shape, node, info: MaterialInfo) -> PhysicsHandle:
        pos, rot, _ = self._node_trs(node)
        body = _Body(shape=shape, itype=info.type, mat=info,
                     pos=pos.copy(), rot=rot.copy(), node=node)
        if info.type == InteractionType.Dynamic and info.mass > 0:
            body.inv_mass = 1.0 / info.mass
            if isinstance(shape, Shape):
                diag = shape.inertia_diag(info.mass)
            elif isinstance(shape, list):
                diag = sum(s.inertia_diag(info.mass / len(shape))
                           + info.mass / len(shape) * np.dot(off, off)
                           for s, off, _ in shape)
            else:
                diag = np.full(3, info.mass)
            body.inv_inertia_local = 1.0 / np.maximum(diag, 1e-12)
        body.copy_from_node = info.type in (InteractionType.Kinematic,
                                            InteractionType.Ghost)
        self._bodies.append(body)
        h = PhysicsHandle(len(self._bodies) - 1, self)
        h.node = node
        self._handles.append(h)
        return h

    def add_object(self, node, part: ConvexMeshPart,
                   info: MaterialInfo) -> PhysicsHandle:
        _, _, scale = self._node_trs(node)
        return self._add_body(self._create_shape(part, scale), node, info)

    def add_compound_object(self, node, parts, info) -> PhysicsHandle:
        _, _, scale = self._node_trs(node)
        children = []
        for part in parts:
            off, rot, cscale = self._node_trs(part.child_node) \
                if part.child_node is not None else \
                (np.zeros(3), np.array([1.0, 0, 0, 0]), scale)
            children.append((self._create_shape(part, cscale), off, rot))
        return self._add_body(children, node, info)

    def add_cube(self, node, info) -> PhysicsHandle:
        return self.add_object(node, ConvexMeshPart(MeshType.Cube), info)

    def add_sphere(self, node, info) -> PhysicsHandle:
        return self.add_object(
            node, ConvexMeshPart(MeshType.Sphere, radius=1.0), info)

    def add_cone(self, node, height, radius, info) -> PhysicsHandle:
        return self.add_object(
            node, ConvexMeshPart(MeshType.Cone, height=height,
                                 radius=radius), info)

    def add_capsule(self, node, height, radius, info) -> PhysicsHandle:
        return self.add_object(
            node, ConvexMeshPart(MeshType.Capsule, height=height,
                                 radius=radius), info)

    def add_cylinder(self, node, height, radius, info) -> PhysicsHandle:
        return self.add_object(
            node, ConvexMeshPart(MeshType.Cylinder, height=height,
                                 radius=radius), info)

    def add_convex_hull(self, node, points, info) -> PhysicsHandle:
        _, _, scale = self._node_trs(node)
        pts = np.asarray(points, np.float64).reshape(-1, 3) * scale
        return self._add_body(ConvexHull(pts), node, info)

    def add_mesh(self, node, index: int, info) -> PhysicsHandle:
        """Static triangle-mesh collider (BvhTriangleMeshShape analogue
        — static-only, like the reference asserts)."""
        assert info.type in (InteractionType.Static, InteractionType.Area)
        return self._add_body(("mesh", index), node, info)

    def add_infinite_plane(self, plane, info) -> PhysicsHandle:
        p = np.asarray(plane, np.float64)
        n = p[:3] / max(np.linalg.norm(p[:3]), 1e-12)
        info.type = InteractionType.Static
        return self._add_body(("plane", np.append(n, p[3])), None, info)

    def remove_body(self, handle: PhysicsHandle) -> None:
        if handle.alive:
            self._bodies[handle.index] = None
            handle.alive = False

    # -- handle statics (hpp:232-236) ------------------------------------
    @staticmethod
    def set_handle_parent(handle, entity) -> None:
        handle.entity = entity

    @staticmethod
    def get_handle_parent(handle):
        return handle.entity

    @staticmethod
    def get_scene_node(handle):
        return handle.node

    @staticmethod
    def get_interaction_type(handle) -> InteractionType:
        return handle.system._bodies[handle.index].itype

    # -- velocity / force API --------------------------------------------
    def set_linear_velocity(self, handle, v) -> None:
        self._bodies[handle.index].linvel = np.asarray(v, np.float64)

    def set_angular_velocity(self, handle, v) -> None:
        self._bodies[handle.index].angvel = np.asarray(v, np.float64)

    def apply_force(self, handle, v, world_pos=None) -> None:
        b = self._bodies[handle.index]
        b.force = b.force + np.asarray(v, np.float64)
        if world_pos is not None:
            b.torque = b.torque + np.cross(
                np.asarray(world_pos, np.float64) - b.pos, v)

    def apply_impulse(self, handle, impulse, world_position) -> None:
        b = self._bodies[handle.index]
        imp = np.asarray(impulse, np.float64)
        b.linvel = b.linvel + b.inv_mass * imp
        r = np.asarray(world_position, np.float64) - b.pos
        b.angvel = b.angvel + self._inv_inertia_world(b) @ np.cross(r, imp)

    # -- constraints (hpp:258-262) ---------------------------------------
    def add_point_constraint(self, handle0, *args, **kw) -> None:
        """(handle, local_pivot) pins to the world; (h0, h1, p0, p1)
        links two bodies (skip_collision accepted, implied here)."""
        if len(args) == 1:
            self._constraints.append((handle0, None,
                                      np.asarray(args[0], np.float64),
                                      None))
        else:
            h1, p0, p1 = args[0], args[1], args[2]
            self._constraints.append((handle0, h1,
                                      np.asarray(p0, np.float64),
                                      np.asarray(p1, np.float64)))

    def add_kinematic_character(self, node) -> "KinematicCharacter":
        ch = KinematicCharacter(self, node)
        self._characters.append(ch)
        return ch

    # -- simulation -------------------------------------------------------
    def iterate(self, frame_time: float) -> None:
        """stepSimulation(frame_time, 20, PHYSICS_TICK)
        (physics_system.cpp:362) + node sync + collision events."""
        # ECS forces (cpp:302-320).
        if self.entity_pool is not None:
            for e, pc, fc in self.entity_pool.get_component_group(
                    PhysicsComponent, ForceComponent):
                if not pc.handle.alive:
                    continue
                b = self._bodies[pc.handle.index]
                b.force = b.force + fc.linear_force
                b.torque = b.torque + fc.torque
        # Kinematic/ghost bodies follow their nodes (cpp:322-360).
        for body in self._bodies:
            if body is not None and body.copy_from_node and \
                    body.node is not None:
                pos, rot, _ = self._node_trs(body.node)
                if PHYSICS_TICK > 0:
                    body.linvel = (pos - body.pos) / max(frame_time, 1e-6)
                body.pos = pos.copy()
                body.rot = rot.copy()

        self._accum = min(self._accum + frame_time, 20 * PHYSICS_TICK)
        new_pairs: set = set()
        pair_info: dict = {}
        while self._accum >= PHYSICS_TICK:
            self._accum -= PHYSICS_TICK
            self._tick(PHYSICS_TICK, new_pairs, pair_info)
            self.tick_callback(PHYSICS_TICK)
        for body in self._bodies:
            if body is not None:
                body.force[:] = 0.0
                body.torque[:] = 0.0

        # Write dynamic transforms back to the scene nodes.
        if self.scene is not None:
            for body in self._bodies:
                if body is not None and body.node is not None and \
                        body.itype == InteractionType.Dynamic:
                    self.scene.translation[body.node] = \
                        body.pos.astype(np.float32)
                    self.scene.rotation[body.node] = \
                        body.rot.astype(np.float32)

        # Collision events for NEW pairs (cpp new_collision_buffer).
        em = EventManager.get()
        for pair in new_pairs - self._prev_pairs:
            ia, ib = pair
            ha = self._handle_for(ia)
            hb = self._handle_for(ib)
            if ha is None or hb is None:
                continue
            point, normal = pair_info[pair]
            em.enqueue(CollisionEvent(
                ha.entity, hb.entity, ha, hb, point, normal))
        self._prev_pairs = new_pairs

    def tick_callback(self, tick_time: float) -> None:
        """Per-fixed-tick hook (cpp:85-91); override or monkeypatch."""

    def _handle_for(self, index):
        for h in self._handles:
            if h.index == index and h.alive:
                return h
        return None

    def _inv_inertia_world(self, b: _Body) -> np.ndarray:
        r = _rot_mat(b.rot)
        return r @ np.diag(b.inv_inertia_local) @ r.T

    def _posed_shapes(self, i: int):
        """World-space convex (sub)shapes of body i as Posed list."""
        b = self._bodies[i]
        if isinstance(b.shape, Shape):
            return [Posed(b.shape, b.pos, b.rot)]
        if isinstance(b.shape, list):
            return [Posed(s, b.pos + quat_rotate(b.rot, off),
                          quat_mul(b.rot, rot))
                    for s, off, rot in b.shape]
        return []

    def _body_aabb(self, i: int) -> np.ndarray:
        b = self._bodies[i]
        if isinstance(b.shape, tuple) and b.shape[0] == "mesh":
            return self._mesh_aabbs[b.shape[1]]
        if isinstance(b.shape, tuple) and b.shape[0] == "plane":
            return np.stack([np.full(3, -1e12), np.full(3, 1e12)])
        posed = self._posed_shapes(i)
        boxes = np.stack([p.aabb() for p in posed])
        return np.stack([boxes[:, 0].min(axis=0), boxes[:, 1].max(axis=0)])

    def _tick(self, dt: float, new_pairs: set, pair_info: dict) -> None:
        bodies = self._bodies
        live = [i for i, b in enumerate(bodies) if b is not None]
        dyn = [i for i in live
               if bodies[i].itype == InteractionType.Dynamic]
        # Integrate velocities (gravity, forces, bullet-style damping).
        for i in dyn:
            b = bodies[i]
            b.linvel = b.linvel + dt * (GRAVITY + b.inv_mass * b.force)
            b.angvel = b.angvel + dt * (
                self._inv_inertia_world(b) @ b.torque)
            b.linvel = b.linvel * np.clip(
                1.0 - b.mat.linear_damping, 0.0, 1.0) ** dt
            b.angvel = b.angvel * np.clip(
                1.0 - b.mat.angular_damping, 0.0, 1.0) ** dt

        contacts = self._collide(live, new_pairs, pair_info)
        self._solve(contacts, dt)
        for ch in self._characters:
            ch.step(dt)

        # Integrate positions.
        for i in dyn:
            b = bodies[i]
            b.pos = b.pos + dt * b.linvel
            if np.dot(b.angvel, b.angvel) > 1e-14:
                b.rot = _quat_from_omega(b.rot, b.angvel, dt)

    # -- collision detection ---------------------------------------------
    def _collide(self, live, new_pairs, pair_info):
        bodies = self._bodies
        n = len(live)
        if n == 0:
            return []
        aabbs = np.stack([self._body_aabb(i) for i in live])
        lo, hi = aabbs[:, 0], aabbs[:, 1]
        m = 0.05
        overlap = ((lo[:, None] <= hi[None] + m).all(axis=2)
                   & (lo[None] <= hi[:, None] + m).all(axis=2))
        contacts = []
        for a in range(n):
            for bb in range(a + 1, n):
                if not overlap[a, bb]:
                    continue
                ia, ib = live[a], live[bb]
                ba, bo = bodies[ia], bodies[ib]
                if ba.itype != InteractionType.Dynamic and \
                        bo.itype != InteractionType.Dynamic:
                    # trigger pairs still track overlaps for events
                    pass
                cs = self._narrowphase(ia, ib)
                if not cs:
                    continue
                trigger = InteractionType.Ghost in (ba.itype, bo.itype) \
                    or InteractionType.Area in (ba.itype, bo.itype)
                key = (min(ia, ib), max(ia, ib))
                new_pairs.add(key)
                if key not in pair_info:
                    pair_info[key] = (cs[0].point, cs[0].normal)
                if not trigger:
                    contacts.extend(cs)
        return contacts

    def _narrowphase(self, ia: int, ib: int):
        """Contacts with normal pointing from ib toward ia."""
        a, b = self._bodies[ia], self._bodies[ib]

        def plane_of(body):
            return body.shape[1] if isinstance(body.shape, tuple) and \
                body.shape[0] == "plane" else None

        def mesh_of(body):
            return body.shape[1] if isinstance(body.shape, tuple) and \
                body.shape[0] == "mesh" else None

        pa, pb = plane_of(a), plane_of(b)
        ma, mb = mesh_of(a), mesh_of(b)
        margin = a.mat.margin + b.mat.margin
        out = []
        if pa is not None or pb is not None:
            # Convex-vs-plane: probe the support in -n plus 4 tilted
            # directions for a resting manifold (a face on the floor
            # yields up to 4 distinct corners -> stable stacking).
            plane = pa if pa is not None else pb
            other_i = ib if pa is not None else ia
            n, d = plane[:3], plane[3]
            nx = np.cross(n, [1.0, 0, 0])
            if np.dot(nx, nx) < 1e-8:
                nx = np.cross(n, [0, 1.0, 0])
            nx /= np.linalg.norm(nx)
            ny = np.cross(n, nx)
            probes = [-n] + [-n + 0.35 * t for t in (nx, -nx, ny, -ny)]
            # contact normal convention: from b toward a
            c_n = -n if pa is not None else n
            for posed in self._posed_shapes(other_i):
                seen = []
                for dprobe in probes:
                    p = posed.support(dprobe)
                    depth = d - np.dot(n, p)     # >0: below the plane
                    if depth > -margin and not any(
                            np.linalg.norm(p - q) < 1e-6 for q in seen):
                        seen.append(p)
                        out.append(_Contact(ia, ib, p, c_n,
                                            max(depth, 0.0) + margin))
            return out
        if ma is not None or mb is not None:
            mesh_i, conv_i = (ia, ib) if ma is not None else (ib, ia)
            mesh = self._meshes[self._bodies[mesh_i].shape[1]]
            box = self._body_aabb(conv_i)
            cand = np.where(
                (mesh._tri_lo <= box[1] + margin).all(axis=1)
                & (mesh._tri_hi >= box[0] - margin).all(axis=1))[0]
            from .shapes import Triangle
            ident = np.array([1.0, 0, 0, 0])
            for t in cand[:64]:
                tri = Posed(Triangle(mesh._tris[t]), np.zeros(3), ident)
                for posed in self._posed_shapes(conv_i):
                    c = self._convex_pair(posed, tri,
                                          margin + mesh.margin)
                    if c is not None:
                        point, normal, depth = c
                        if conv_i == ia:
                            out.append(_Contact(ia, ib, point, normal,
                                                depth))
                        else:
                            out.append(_Contact(ia, ib, point, -normal,
                                                depth))
            return out
        for sa in self._posed_shapes(ia):
            for sb in self._posed_shapes(ib):
                c = self._convex_pair(sa, sb, margin)
                if c is not None:
                    for point, normal, depth in self._manifold(
                            sa, sb, *c, margin):
                        out.append(_Contact(ia, ib, point, normal,
                                            depth))
        return out

    @staticmethod
    def _convex_pair(sa: Posed, sb: Posed, margin: float):
        """(point, normal b->a, depth) or None."""
        dist, pa, pb, n = gjk_distance(sa, sb)
        if dist > 0:
            if dist >= margin:
                return None
            return (0.5 * (pa + pb), n, margin - dist)
        res = epa_penetration(sb, sa)   # normal from b toward a
        if res is None:
            return None
        depth, n, point = res
        return (point, n, depth + margin)

    @staticmethod
    def _manifold(sa: Posed, sb: Posed, point, n, depth, margin):
        """Expand a single GJK/EPA contact into a resting manifold:
        probe each shape's support in tilted-normal directions — a face
        resting on a face yields its corners — keeping only probe
        points verified inside the other shape (a fast point-vs-convex
        GJK kills phantom overhang corners).  Single-point EPA
        manifolds make stacked boxes rock and tip; this is the standard
        perturbed-support manifold instead of full face clipping."""
        t1 = np.cross(n, [1.0, 0, 0])
        if np.dot(t1, t1) < 1e-8:
            t1 = np.cross(n, [0, 1.0, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        base = np.dot(n, point)
        out = [(point, n, depth)]
        ident = np.array([1.0, 0, 0, 0])
        del base
        for tilt in (t1, -t1, t2, -t2):
            for shape, d0 in ((sa, -n), (sb, n)):
                p = shape.support(d0 + 0.3 * tilt)
                # Conservative per-corner depth: full at the witness
                # plane, decaying with normal-distance from it.
                d_i = depth - abs(np.dot(n, p - point))
                if d_i <= 1e-6:
                    continue
                if any(np.linalg.norm(p - q[0]) < 1e-6 for q in out):
                    continue
                other = sb if shape is sa else sa
                pt = Posed(Sphere(0.0), p, ident)
                dist_o, *_ = gjk_distance(pt, other)
                if dist_o <= margin:
                    out.append((p, n, max(d_i, 0.0)))
        return out

    # -- solver -----------------------------------------------------------
    def _solve(self, contacts, dt: float) -> None:
        bodies = self._bodies
        rows = []
        for c in contacts:
            a, b = bodies[c.ia], bodies[c.ib]
            if a.inv_mass == 0 and b.inv_mass == 0:
                continue
            rows.append(self._prep_row(c, dt))
        crows = []
        for k, (h0, h1, p0, p1) in enumerate(self._constraints):
            if not h0.alive or (h1 is not None and not h1.alive):
                continue
            crows.append((k, h0.index,
                          h1.index if h1 is not None else None, p0, p1))
        for _ in range(SOLVER_ITERS):
            for row in rows:
                self._solve_row(row)
            for (k, i0, i1, p0, p1) in crows:
                self._solve_point_constraint(k, i0, i1, p0, p1, dt)
        # Positional correction (split-impulse second half).
        for row in rows:
            c = row["c"]
            a, b = bodies[c.ia], bodies[c.ib]
            corr = BAUMGARTE * max(c.depth - PENETRATION_SLOP, 0.0)
            corr = min(corr, 0.2)
            ksum = a.inv_mass + b.inv_mass
            if ksum <= 0:
                continue
            a.pos = a.pos + (a.inv_mass / ksum) * corr * c.normal
            b.pos = b.pos - (b.inv_mass / ksum) * corr * c.normal

    def _prep_row(self, c: _Contact, dt: float):
        a, b = self._bodies[c.ia], self._bodies[c.ib]
        ra = c.point - a.pos
        rb = c.point - b.pos
        n = c.normal
        iia = self._inv_inertia_world(a)
        iib = self._inv_inertia_world(b)
        k_n = a.inv_mass + b.inv_mass \
            + np.dot(n, np.cross(iia @ np.cross(ra, n), ra)) \
            + np.dot(n, np.cross(iib @ np.cross(rb, n), rb))
        # restitution from pre-solve closing speed
        rel = (a.linvel + np.cross(a.angvel, ra)
               - b.linvel - np.cross(b.angvel, rb))
        vn = np.dot(rel, n)
        e = 0.5 * (a.mat.restitution + b.mat.restitution)
        # Split impulse: restitution only in the velocity bias;
        # penetration is fixed by a positional pass (plain Baumgarte
        # velocity bias injects energy and bounces e=0 contacts).
        bias = -e * vn if -vn > RESTITUTION_THRESHOLD else 0.0
        t1 = np.cross(n, [1.0, 0, 0])
        if np.dot(t1, t1) < 1e-8:
            t1 = np.cross(n, [0, 1.0, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        mu = 0.5 * (a.mat.friction + b.mat.friction)
        return {"c": c, "ra": ra, "rb": rb, "n": n,
                "kn": max(k_n, 1e-12), "bias": bias,
                "t": (t1, t2), "mu": mu, "jn": 0.0, "jt": [0.0, 0.0],
                "iia": iia, "iib": iib}

    def _solve_row(self, row) -> None:
        c = row["c"]
        a, b = self._bodies[c.ia], self._bodies[c.ib]
        ra, rb, n = row["ra"], row["rb"], row["n"]
        rel = (a.linvel + np.cross(a.angvel, ra)
               - b.linvel - np.cross(b.angvel, rb))
        vn = np.dot(rel, n)
        dj = (-vn + row["bias"]) / row["kn"]
        j0 = row["jn"]
        row["jn"] = max(j0 + dj, 0.0)
        dj = row["jn"] - j0
        imp = dj * n
        self._apply(a, b, imp, ra, rb, row)
        # friction rows
        for k, t in enumerate(row["t"]):
            rel = (a.linvel + np.cross(a.angvel, ra)
                   - b.linvel - np.cross(b.angvel, rb))
            vt = np.dot(rel, t)
            kt = a.inv_mass + b.inv_mass \
                + np.dot(t, np.cross(row["iia"] @ np.cross(ra, t), ra)) \
                + np.dot(t, np.cross(row["iib"] @ np.cross(rb, t), rb))
            dj = -vt / max(kt, 1e-12)
            lim = row["mu"] * row["jn"]
            j0 = row["jt"][k]
            row["jt"][k] = np.clip(j0 + dj, -lim, lim)
            dj = row["jt"][k] - j0
            self._apply(a, b, dj * t, ra, rb, row)
        # rolling friction: angular impulse opposing relative spin
        rf = 0.5 * (a.mat.rolling_friction + b.mat.rolling_friction)
        if rf > 0 and row["jn"] > 0:
            wrel = a.angvel - b.angvel
            wn = np.linalg.norm(wrel)
            if wn > 1e-9:
                mag = min(rf * row["jn"], wn * 0.05)
                dw = -wrel / wn * mag
                a.angvel = a.angvel + row["iia"] @ dw \
                    * (1.0 if a.inv_mass > 0 else 0.0)
                b.angvel = b.angvel - row["iib"] @ dw \
                    * (1.0 if b.inv_mass > 0 else 0.0)

    @staticmethod
    def _apply(a, b, imp, ra, rb, row) -> None:
        if a.inv_mass > 0:
            a.linvel = a.linvel + a.inv_mass * imp
            a.angvel = a.angvel + row["iia"] @ np.cross(ra, imp)
        if b.inv_mass > 0:
            b.linvel = b.linvel - b.inv_mass * imp
            b.angvel = b.angvel - row["iib"] @ np.cross(rb, imp)

    def _solve_point_constraint(self, k, i0, i1, p0, p1, dt) -> None:
        a = self._bodies[i0]
        ra = quat_rotate(a.rot, p0)
        wa = a.pos + ra
        if i1 is None:
            target = self._anchors.get(k)
            if target is None:
                self._anchors[k] = wa.copy()
                target = wa
            vb = np.zeros(3)
            wb = target
            inv_b = 0.0
            iib = np.zeros((3, 3))
            rb = np.zeros(3)
            b = None
        else:
            b = self._bodies[i1]
            rb = quat_rotate(b.rot, p1)
            wb = b.pos + rb
            vb = b.linvel + np.cross(b.angvel, rb)
            inv_b = b.inv_mass
            iib = self._inv_inertia_world(b)
        iia = self._inv_inertia_world(a)
        va = a.linvel + np.cross(a.angvel, ra)
        err = wa - wb
        vel = va - vb + BAUMGARTE / dt * err

        def skew(r):
            return np.array([[0, -r[2], r[1]],
                             [r[2], 0, -r[0]],
                             [-r[1], r[0], 0]])

        # Full 3x3 effective mass K = (ma+mb) I - [ra]x Ia [ra]x - ...
        sa_ = skew(ra)
        k_mat = (a.inv_mass + inv_b) * np.eye(3) - sa_ @ iia @ sa_
        if b is not None:
            sb_ = skew(rb)
            k_mat = k_mat - sb_ @ iib @ sb_
        imp = -np.linalg.solve(k_mat + 1e-9 * np.eye(3), vel)
        a.linvel = a.linvel + a.inv_mass * imp
        a.angvel = a.angvel + iia @ np.cross(ra, imp)
        if b is not None and b.inv_mass > 0:
            b.linvel = b.linvel - b.inv_mass * imp
            b.angvel = b.angvel - iib @ np.cross(rb, imp)

    # -- queries ----------------------------------------------------------
    def query_closest_hit_ray(self, origin, direction, length,
                              mask=INTERACTION_TYPE_ALL_BITS
                              ) -> RaycastResult:
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        best = RaycastResult()
        for h in self._handles:
            if not h.alive:
                continue
            b = self._bodies[h.index]
            if not (_TYPE_BITS[b.itype] & mask):
                continue
            t_n = self._ray_body(o, d, h.index, length)
            if t_n is not None and t_n[0] < best.t:
                best = RaycastResult(
                    entity=h.entity, handle=h,
                    world_pos=o + t_n[0] * d, world_normal=t_n[1],
                    t=t_n[0])
        return best

    def _ray_body(self, o, d, i, length):
        b = self._bodies[i]
        if isinstance(b.shape, tuple) and b.shape[0] == "plane":
            n, dd = b.shape[1][:3], b.shape[1][3]
            denom = np.dot(n, d)
            if abs(denom) < 1e-12:
                return None
            t = (dd - np.dot(n, o)) / denom
            return (t, n if denom < 0 else -n) \
                if 0 <= t <= length else None
        if isinstance(b.shape, tuple) and b.shape[0] == "mesh":
            mesh = self._meshes[b.shape[1]]
            hit = ray_triangles(o, d, mesh._tris, length)
            return (hit[0], hit[2]) if hit is not None else None
        best = None
        for posed in self._posed_shapes(i):
            lo = quat_rotate(posed._conj, o - posed.pos)
            ld = quat_rotate(posed._conj, d)
            s = posed.shape
            if isinstance(s, Sphere):
                t = ray_sphere(lo, ld, s.radius)
            elif isinstance(s, Box):
                t = ray_box(lo, ld, s.half)
            else:
                t = ray_convex_trace(o, d, posed, length)
            if t is not None and 0 <= t <= length and \
                    (best is None or t < best[0]):
                p = o + t * d
                # normal: gradient of support distance (central diff via
                # GJK point distance)
                eps = 1e-4
                pt = Posed(Sphere(0.0), p, np.array([1.0, 0, 0, 0]))
                grads = []
                for ax in range(3):
                    dp = np.zeros(3)
                    dp[ax] = eps
                    d1 = gjk_distance(Posed(Sphere(0.0), p + dp,
                                            pt.rot), posed)[0]
                    d2 = gjk_distance(Posed(Sphere(0.0), p - dp,
                                            pt.rot), posed)[0]
                    grads.append(d1 - d2)
                g = np.asarray(grads)
                gn = np.linalg.norm(g)
                best = (t, g / gn if gn > 1e-12 else -d)
        return best

    def get_overlapping_objects(self, handle, method="Nearphase"):
        """hpp:270-276 — returns list of overlapping handles."""
        out = []
        box = self._body_aabb(handle.index)
        for h in self._handles:
            if not h.alive or h.index == handle.index:
                continue
            other = self._body_aabb(h.index)
            if (box[0] <= other[1]).all() and (other[0] <= box[1]).all():
                if method == "Broadphase" or str(method) == \
                        "OverlapMethod.Broadphase":
                    out.append(h)
                elif self._narrowphase(handle.index, h.index):
                    out.append(h)
        return out


class KinematicCharacter:
    """Bullet-style kinematic character (physics_system.hpp:68-85):
    unit sphere scaled by the node, walk velocity, gravity, jump,
    grounded test; moves by sweep-and-slide against the world."""

    GRAVITY = 9.81
    MAX_SLOPE_NY = 0.5      # ground normals need y > this

    def __init__(self, system: PhysicsSystem, node):
        self.system = system
        self.node = node
        pos, _, scale = system._node_trs(node)
        self.radius = float(np.max(scale))
        self.pos = pos.astype(np.float64).copy()
        self.vel_y = 0.0
        self.walk = np.zeros(3)
        self._grounded = False

    def set_move_velocity(self, v) -> None:
        self.walk = np.asarray(v, np.float64)

    def jump(self, v) -> None:
        if self._grounded:
            self.vel_y = float(np.asarray(v, np.float64)[1])
            self._grounded = False

    def is_grounded(self) -> bool:
        return self._grounded

    def step(self, dt: float) -> None:
        self.vel_y -= self.GRAVITY * dt
        delta = self.walk * dt + np.array([0.0, self.vel_y * dt, 0.0])
        self.pos = self.pos + delta
        # Penetration recovery against every solid body (<= 8 passes).
        self._grounded = False
        me = Posed(Sphere(self.radius), self.pos,
                   np.array([1.0, 0, 0, 0]))
        for _ in range(8):
            moved = False
            for h in self.system._handles:
                if not h.alive:
                    continue
                b = self.system._bodies[h.index]
                if b.itype in (InteractionType.Ghost,
                               InteractionType.Area):
                    continue
                res = self._depenetrate(h.index, me)
                if res is not None:
                    n, depth = res
                    self.pos = self.pos + n * depth
                    me = Posed(Sphere(self.radius), self.pos, me.rot)
                    if n[1] > self.MAX_SLOPE_NY:
                        self._grounded = True
                        self.vel_y = max(self.vel_y, 0.0)
                    moved = True
            if not moved:
                break
        if self.system.scene is not None and self.node is not None:
            self.system.scene.translation[self.node] = \
                self.pos.astype(np.float32)

    def _depenetrate(self, i, me: Posed):
        """Push-out (normal, depth) for the character sphere vs body i,
        or None.  Uses point-vs-convex GJK: dist(center, shape) <
        radius => depth = radius - dist along the center-away normal —
        no EPA needed unless the center itself is inside."""
        b = self.system._bodies[i]
        if isinstance(b.shape, tuple) and b.shape[0] == "plane":
            n, d = b.shape[1][:3], b.shape[1][3]
            depth = self.radius - (np.dot(n, self.pos) - d)
            return (n, depth) if depth > 0 else None
        center = Posed(Sphere(0.0), self.pos, np.array([1.0, 0, 0, 0]))
        if isinstance(b.shape, tuple) and b.shape[0] == "mesh":
            mesh = self.system._meshes[b.shape[1]]
            lo = self.pos - self.radius
            hi = self.pos + self.radius
            cand = np.where((mesh._tri_lo <= hi).all(axis=1)
                            & (mesh._tri_hi >= lo).all(axis=1))[0]
            from .shapes import Triangle
            ident = np.array([1.0, 0, 0, 0])
            best = None
            for t in cand[:32]:
                tri = Posed(Triangle(mesh._tris[t]), np.zeros(3), ident)
                dist, _, _, n = gjk_distance(center, tri)
                if dist < self.radius and n is not None:
                    depth = self.radius - dist
                    if best is None or depth > best[1]:
                        best = (n, depth)
            return best
        best = None
        for posed in self.system._posed_shapes(i):
            dist, _, _, n = gjk_distance(center, posed)
            if n is None:
                res = epa_penetration(posed, center)
                if res is not None:
                    best = (-res[1], res[0] + self.radius)
            elif dist < self.radius:
                depth = self.radius - dist
                if best is None or depth > best[1]:
                    best = (n, depth)
        return best
