"""The port's physics (granite_tpu_torch/physics) held equal to the JAX
package's: seeded scenarios run through the JAX PhysicsSystem on a JAX
Scene and the port's on the port's Scene in lockstep.  After every
iterate the node TRS arrays, every body's state, the kinematic
characters and the sequence of CollisionEvents (handles, entities,
points, normals) must be equal bit for bit (tolerance 0): the copy keeps
the original's float64 operation order.  Each scenario simulates at most
0.25 s (75 ticks of 1/300 s); tests/test_physics.py holds the longer
behaviour.  Also gjk_distance, epa_penetration and the four ray tests on
64 seeded pose pairs, and the two reference faults the copy fixes."""

import numpy as np
import pytest

from granite_tpu import physics as JP
from granite_tpu.event import manager as JEM
from granite_tpu.physics import shapes as JSH
from granite_tpu.scene import scene as JS
from granite_tpu_torch import physics as TP
from granite_tpu_torch.event import manager as TEM
from granite_tpu_torch.physics import physics_system as TPS
from granite_tpu_torch.physics import shapes as TSH
from granite_tpu_torch.scene import scene as TS
from test_torch_ecs import time_limit

RNG_SEED = 17
DT = 1.0 / 60.0                  # 5 ticks an iterate
MAX_ITERATES = 15                # 0.25 s, 75 ticks
TEST_LIMIT_S = 40
POSE_PAIRS = 64
# (physics package, its shapes module, Scene module, event manager)
PKGS = {"jax": (JP, JSH, JS, JEM), "torch": (TP, TSH, TS, TEM)}


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(TEST_LIMIT_S):
        yield


def _world(P, S, friction=0.8):
    sys_ = P.PhysicsSystem()
    scene = S.Scene()
    sys_.set_scene(scene)
    floor = sys_.add_infinite_plane(
        [0.0, 1.0, 0.0, 0.0],
        P.MaterialInfo(type=P.InteractionType.Static, friction=friction))
    P.PhysicsSystem.set_handle_parent(floor, "floor")
    return sys_, scene


# -- scenarios: (P, S) -> (system, scene, [one callable an iterate]) -----------

def falling_sphere(P, S):
    sys_, scene = _world(P, S)
    node = scene.create_node(translation=[0.1, 1.15, -0.2])
    h = sys_.add_sphere(node, P.MaterialInfo(mass=1.0, restitution=0.0))
    P.PhysicsSystem.set_handle_parent(h, "ball")
    return sys_, scene, [lambda: sys_.iterate(DT)] * MAX_ITERATES


def restitution(P, S):
    sys_, scene = _world(P, S)
    node = scene.create_node(translation=[0.0, 1.2, 0.0])
    h = sys_.add_sphere(node, P.MaterialInfo(
        mass=1.0, restitution=0.9, linear_damping=0.0))
    sys_.set_linear_velocity(h, [0.3, -4.0, 0.0])
    sys_.set_angular_velocity(h, [0.0, 0.5, 1.0])
    return sys_, scene, [lambda: sys_.iterate(DT)] * MAX_ITERATES


def box_stack(P, S):
    sys_, scene = _world(P, S)
    n0 = scene.create_node(translation=[0, 0.5, 0], scale=[0.5, 0.5, 0.5])
    n1 = scene.create_node(translation=[0.05, 1.55, 0],
                           scale=[0.5, 0.5, 0.5])
    for n, name in ((n0, "box0"), (n1, "box1")):
        h = sys_.add_cube(n, P.MaterialInfo(mass=1.0, restitution=0.0,
                                            friction=0.9))
        P.PhysicsSystem.set_handle_parent(h, name)
    return sys_, scene, [lambda: sys_.iterate(DT)] * MAX_ITERATES


def pendulum(P, S):
    sys_, scene = _world(P, S)
    node = scene.create_node(translation=[2.0, 5.0, 0])
    h = sys_.add_sphere(node, P.MaterialInfo(
        mass=1.0, linear_damping=0.0, restitution=0.0))
    sys_.add_point_constraint(h, [-2.0, 0.0, 0.0])
    # and a second body hung from the first by a body-body link
    n2 = scene.create_node(translation=[2.0, 2.8, 0.3])
    h2 = sys_.add_cube(n2, P.MaterialInfo(mass=0.5))
    sys_.add_point_constraint(h, h2, [0.0, -1.0, 0.0], [0.0, 1.3, -0.3])
    return sys_, scene, [lambda: sys_.iterate(DT)] * MAX_ITERATES


def character(P, S):
    sys_, scene = _world(P, S)
    # a unit wall whose face (x = -1.2) the character reaches in 0.15 s
    wall = scene.create_node(translation=[-0.2, 1.0, 0.0])
    sys_.add_cube(wall, P.MaterialInfo(type=P.InteractionType.Static))
    node = scene.create_node(translation=[-2.5, 1.02, 0])
    ch = sys_.add_kinematic_character(node)
    ch.set_move_velocity([2.0, 0, 0.5])

    def jump():
        ch.jump([0, 5.0, 0])
        sys_.iterate(DT)
    return sys_, scene, ([lambda: sys_.iterate(DT)] * 6 + [jump]
                         + [lambda: sys_.iterate(DT)] * 8)


def ghost_area(P, S):
    sys_, scene = _world(P, S)
    # a thin area slab a box falls into, and a small ghost box that its
    # node carries across the slab (boxes: EPA on a sphere deep in a box
    # takes ~60 ms a call)
    na = scene.create_node(translation=[0, 0.8, 0], scale=[1.5, 0.25, 1.5])
    ha = sys_.add_cube(na, P.MaterialInfo(type=P.InteractionType.Area))
    ng = scene.create_node(translation=[2.2, 0.8, 0], scale=[0.3] * 3)
    hg = sys_.add_cube(ng, P.MaterialInfo(type=P.InteractionType.Ghost))
    nd = scene.create_node(translation=[0, 1.6, 0], scale=[0.5] * 3)
    hd = sys_.add_cube(nd, P.MaterialInfo(mass=1.0, restitution=0.0))
    for h, name in ((ha, "area"), (hg, "ghost"), (hd, "ball")):
        P.PhysicsSystem.set_handle_parent(h, name)

    def move_ghost():
        # the ghost follows its node into the ball's path
        scene.translation[ng] = scene.translation[ng] - [0.3, 0, 0]
        sys_.iterate(DT)
    return sys_, scene, [move_ghost] * MAX_ITERATES


def compound_removed(P, S):
    sys_, scene = _world(P, S)
    node = scene.create_node(translation=[0, 3.0, 0])
    child = scene.create_node(translation=[0.8, 0.2, 0], scale=[0.3, 0.6, 0.3])
    parts = [P.ConvexMeshPart(P.MeshType.Sphere, radius=0.5),
             P.ConvexMeshPart(P.MeshType.Cube),
             P.ConvexMeshPart(P.MeshType.Capsule, child_node=child,
                              height=1.0, radius=0.4)]
    h = sys_.add_compound_object(node, parts, P.MaterialInfo(mass=2.0))
    sys_.set_angular_velocity(h, [0.4, 0.0, 0.9])
    other = scene.create_node(translation=[2.5, 0.6, 0])
    sys_.add_cylinder(other, 1.0, 0.5, P.MaterialInfo(mass=1.0))

    def remove():
        sys_.remove_body(h)
        sys_.iterate(DT)
    return sys_, scene, ([lambda: sys_.iterate(DT)] * 9 + [remove]
                         + [lambda: sys_.iterate(DT)] * 5)


def force_component(P, S):
    sys_, scene = _world(P, S)
    sys_.set_entity_pool(scene.entity_pool)
    node = scene.create_node(translation=[0, 5.0, 0])
    h = sys_.add_sphere(node, P.MaterialInfo(mass=1.0, linear_damping=0.0))
    cone = scene.create_node(translation=[3.0, 2.0, 1.0])
    hc = sys_.add_cone(cone, 1.0, 0.5, P.MaterialInfo(mass=1.0))
    forces = []
    for handle, f, tq in ((h, [50.0, 9.81, 0.0], [0, 0, 0]),
                          (hc, [0.0, 12.0, -3.0], [0.0, 2.0, 0.5])):
        e = scene.entity_pool.create_entity()
        e.allocate_component(P.PhysicsComponent, handle)
        forces.append(e.allocate_component(P.ForceComponent,
                                           linear_force=f, torque=tq))
    sys_.apply_force(hc, [1.0, 0.0, 0.0], [3.0, 2.5, 1.0])

    def push():
        forces[0].linear_force = forces[0].linear_force * 0.5
        sys_.iterate(DT)
    return sys_, scene, [push] * 10


SCENARIOS = {f.__name__: f for f in (
    falling_sphere, restitution, box_stack, pendulum, character,
    ghost_area, compound_removed, force_component)}


def _state(sys_, scene, events) -> dict:
    """Everything a scenario compares, as plain values."""
    n = scene.num_nodes
    bodies = []
    for b in sys_._bodies:
        if b is None:
            bodies.append(None)
            continue
        bodies.append([b.itype.name, b.inv_mass, b.copy_from_node, b.node,
                       *(np.asarray(v) for v in (
                           b.pos, b.rot, b.linvel, b.angvel, b.force,
                           b.torque, b.inv_inertia_local))])
    chars = [(np.asarray(c.pos), c.vel_y, c._grounded, c.radius)
             for c in sys_._characters]
    evs = [(ev.get_first_handle().index, ev.get_second_handle().index,
            ev.get_first_entity(), ev.get_second_entity(),
            np.asarray(ev.get_world_contact()),
            np.asarray(ev.get_world_normal())) for ev in events]
    return {"trs": [scene.translation[:n], scene.rotation[:n],
                    scene.scale[:n]],
            "bodies": bodies, "chars": chars, "events": evs,
            "pairs": sorted(sys_._prev_pairs), "accum": sys_._accum}


def _same(a, b, where: str) -> None:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where          # tolerance 0
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _lockstep(build) -> list:
    """Run one scenario through both packages an iterate at a time,
    comparing after each; -> each package's events."""
    worlds = {}
    for name, (P, _SH, S, EM) in PKGS.items():
        EM.EventManager.reset()
        events = []
        EM.EventManager.get().register_handler(P.CollisionEvent,
                                               events.append)
        worlds[name] = (*build(P, S), events, EM)
    try:
        steps = {k: w[2] for k, w in worlds.items()}
        assert len(steps["jax"]) == len(steps["torch"]) <= MAX_ITERATES
        for i in range(len(steps["jax"])):
            states = {}
            for name, (sys_, scene, _s, events, EM) in worlds.items():
                steps[name][i]()
                EM.EventManager.get().dispatch()
                states[name] = _state(sys_, scene, events)
            _same(states["jax"], states["torch"], f"iterate {i}")
        for name, (P, *_r) in PKGS.items():
            # each bus saw its own package's events only
            assert all(type(ev) is P.CollisionEvent
                       for ev in worlds[name][3])
        return [worlds[k][3] for k in PKGS]
    finally:
        JEM.EventManager.reset()
        TEM.EventManager.reset()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(name):
    jax_events, _ = _lockstep(SCENARIOS[name])
    if name in ("falling_sphere", "restitution", "box_stack", "ghost_area"):
        assert jax_events, f"{name}: no CollisionEvent in 0.25 s"


def test_scenarios_behave():
    """The scenarios do what they stage (on the port, whose states the
    lockstep test holds equal to the JAX package's)."""
    sys_, scene, steps = falling_sphere(TP, TS)
    for s in steps:
        s()
    b = sys_._bodies[1]
    assert abs(b.pos[1] - 1.0) < 0.05 and b.linvel[1] > -0.5
    sys_, scene, steps = character(TP, TS)
    ch = sys_._characters[0]
    for k, s in enumerate(steps):
        s()
        if k == 5:
            assert ch.is_grounded()
        if k == 6:
            assert ch.pos[1] > 1.02          # airborne after the jump
    assert -2.3 < ch.pos[0] < -2.2 + 1e-3    # held at the wall's face
    assert ch.pos[2] > 0.1                    # and sliding along it
    sys_, scene, steps = compound_removed(TP, TS)
    for s in steps:
        s()
    assert sys_._bodies[1] is None and scene.translation[0][1] < 3.0


# -- shapes: GJK, EPA and the ray tests on seeded pose pairs ------------------

def _shape(SH, rng):
    k = int(rng.integers(0, 6))
    r, h = (float(x) for x in rng.uniform(0.2, 1.5, size=2))
    if k == 0:
        return SH.Sphere(r)
    if k == 1:
        return SH.Box(rng.uniform(0.2, 1.5, size=3))
    if k == 2:
        return SH.Capsule(r, h)
    if k == 3:
        return SH.Cylinder(r, h)
    if k == 4:
        return SH.Cone(r, h)
    return SH.ConvexHull(rng.normal(size=(int(rng.integers(4, 12)), 3)))


def _quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def _queries(SH, seed: int) -> list:
    """gjk_distance, epa_penetration (on the overlapping pairs) and
    ray_sphere / ray_box / ray_convex_trace / ray_triangles on
    POSE_PAIRS seeded pose pairs; -> every result."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(POSE_PAIRS):
        a = SH.Posed(_shape(SH, rng), rng.normal(size=3), _quat(rng))
        b = SH.Posed(_shape(SH, rng), rng.normal(size=3) * 1.2, _quat(rng))
        out.append(SH.gjk_distance(a, b))
        out.append(SH.epa_penetration(a, b) if out[-1][0] == 0.0 else None)
        o = rng.normal(size=3) * 4
        d = -o + rng.normal(size=3)
        d /= np.linalg.norm(d)
        out.append(SH.ray_sphere(o, d, float(rng.uniform(0.3, 2))))
        out.append(SH.ray_box(o, d, rng.uniform(0.3, 2, size=3)))
        out.append(SH.ray_convex_trace(o, d, b, 12.0))
        out.append(SH.ray_triangles(o, d, rng.normal(size=(16, 3, 3)) * 2,
                                    12.0))
    return out


def test_shape_queries_match():
    got, want = _queries(TSH, RNG_SEED), _queries(JSH, RNG_SEED)
    _same(got, want, "queries")
    overlapping = sum(r is not None for r in got[1::6])
    hits = sum(r is not None for k in (2, 3, 4, 5) for r in got[k::6])
    assert 4 <= overlapping < POSE_PAIRS and hits > POSE_PAIRS


def test_system_queries_match():
    """query_closest_hit_ray (plane, sphere, box, capsule, triangle mesh,
    masks) and get_overlapping_objects on the same world."""
    rng = np.random.default_rng(RNG_SEED + 1)
    rays = [(rng.normal(size=3) * 3 + [0, 3, 0], rng.normal(size=3))
            for _ in range(24)]
    res = []
    for P, _SH, S, _EM in PKGS.values():
        sys_, scene = _world(P, S)
        for i, t in enumerate(((0, 1, -3), (2, 1, -3), (-2, 1.5, -2))):
            node = scene.create_node(translation=t, rotation=_quat(
                np.random.default_rng(i)))
            info = P.MaterialInfo(type=P.InteractionType.Static)
            (sys_.add_sphere, sys_.add_cube,
             lambda n, m: sys_.add_capsule(n, 1.0, 0.5, m))[i](node, info)
        mesh = P.CollisionMesh(
            indices=np.array([[0, 1, 2], [0, 2, 3]], np.uint32),
            positions=np.array([[-4, 0.5, 2], [4, 0.5, 2], [4, 4, 2],
                                [-4, 4, 2]], np.float32))
        sys_.add_mesh(scene.create_node(), sys_.register_collision_mesh(mesh),
                      P.MaterialInfo(type=P.InteractionType.Static))
        out = []
        for o, d in rays:
            for mask in (P.INTERACTION_TYPE_ALL_BITS,
                         P.INTERACTION_TYPE_DYNAMIC_BIT):
                r = sys_.query_closest_hit_ray(o, d, 20.0, mask)
                out.append((bool(r), r.t, r.world_pos, r.world_normal,
                            r.handle.index if r else None))
        out.append([[h.index for h in sys_.get_overlapping_objects(h, m)]
                    for h in sys_._handles
                    for m in ("Nearphase", "Broadphase")])
        res.append(out)
    _same(res[0], res[1], "system queries")
    assert sum(r[0] for r in res[0][:-1]) >= 8


# -- reference faults fixed in the copy ----------------------------------------

def _two_pins(P, S):
    """A bar pinned to the world at both ends (local +-1 on x)."""
    sys_, scene = _world(P, S)
    node = scene.create_node(translation=[0.0, 4.0, 0.0],
                             scale=[1.0, 0.1, 0.1])
    h = sys_.add_cube(node, P.MaterialInfo(mass=1.0, linear_damping=0.0))
    sys_.add_point_constraint(h, [-1.0, 0.0, 0.0])
    sys_.add_point_constraint(h, [1.0, 0.0, 0.0])
    for _ in range(MAX_ITERATES):
        sys_.iterate(DT)
    b = sys_._bodies[h.index]
    rot = TPS._rot_mat(b.rot)
    return [float(np.linalg.norm(b.pos + rot @ [s, 0, 0] - [s, 4.0, 0]))
            for s in (-1.0, 1.0)]


def test_two_world_pins_keep_their_anchors():
    """The JAX package keeps a world pin's anchor per body, so the second
    pin pulls its pivot to the first pin's anchor, 2 m away; the port
    keeps an anchor per constraint and the bar hangs where it was
    pinned (within the soft constraint's 1 cm)."""
    jax_err, port_err = _two_pins(JP, JS), _two_pins(TP, TS)
    assert max(port_err) < 0.01
    assert max(jax_err) > 0.5


def test_force_on_a_removed_body():
    """A ForceComponent whose body was removed: the JAX package's iterate
    raises on the removed slot; the port skips it, and the bodies that
    remain move as in a world where the removed body never had one."""
    runs = {}
    for name, (P, _SH, S, _EM) in PKGS.items():
        for keep_force in (True, False):
            sys_, scene = _world(P, S)
            sys_.set_entity_pool(scene.entity_pool)
            h = sys_.add_sphere(scene.create_node(translation=[0, 3, 0]),
                                P.MaterialInfo(mass=1.0))
            other = sys_.add_sphere(scene.create_node(translation=[4, 3, 0]),
                                    P.MaterialInfo(mass=1.0))
            e = scene.entity_pool.create_entity()
            e.allocate_component(P.PhysicsComponent, h)
            e.allocate_component(P.ForceComponent, linear_force=[5, 0, 0])
            sys_.iterate(DT)
            sys_.remove_body(h)
            if not keep_force:
                e.free_component(P.ForceComponent)
            try:
                sys_.iterate(DT)
            except AttributeError:
                runs[name, keep_force] = "raised"
                continue
            runs[name, keep_force] = sys_._bodies[other.index].pos
    assert runs["jax", True] == "raised"
    _same(runs["torch", True], runs["torch", False], "remaining body")
    _same(runs["torch", False], runs["jax", False], "without the force")
