"""The port's ECS (granite_tpu_torch/scene/ecs.py) and the entity half of
its Scene held equal to the JAX package's: tests/test_ecs.py's group-query
contract run on both EntityPool classes, and the same nodes, renderables,
decals, fog regions and diffuse volumes built through both Scene classes,
compared entity by entity.  Host copies of the same code: every
comparison is exact (tolerance 0)."""

import contextlib
import signal

import numpy as np
import pytest

from granite_tpu.scene import ecs as JE
from granite_tpu.scene import scene as JS
from granite_tpu_torch.scene import ecs as TE
from granite_tpu_torch.scene import scene as TS

RNG_SEED = 13
TEST_LIMIT_S = 30
ECS = pytest.mark.parametrize("E", [JE, TE], ids=["jax", "torch"])
SCENES = pytest.mark.parametrize("S", [JS, TS], ids=["jax", "torch"])
# The component sets the JAX Scene populates, by class name.
GROUPS = (
    ("TransformComponent",),
    ("RenderableComponent",),
    ("BoundedComponent",),
    ("RenderableComponent", "OpaqueComponent"),
    ("RenderableComponent", "TransparentComponent"),
    ("RenderableComponent", "CastsShadowComponent"),
    ("RenderableComponent", "DynamicComponent"),
    ("BoundedComponent", "CastsShadowComponent", "DynamicComponent"),
    ("VolumetricDecalComponent", "TransformComponent"),
    ("VolumetricDiffuseLightComponent", "TransformComponent"),
    ("TransformComponent", "RenderableComponent"),
)


@contextlib.contextmanager
def time_limit(seconds: float):
    """Raise TimeoutError inside the test once it has run `seconds` (a
    SIGALRM timer; pytest and its xdist workers run tests on the main
    thread), so a hung socket or simulation fails its test alone."""
    def fire(_signum, _frame):
        raise TimeoutError(f"test ran past its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, fire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(TEST_LIMIT_S):
        yield


class A:
    def __init__(self, v=0):
        self.v = v


class B:
    def __init__(self, v=0):
        self.v = v


class C:
    pass


def component_fields(c) -> tuple:
    """(class name, its fields) of one component, slots or dict."""
    names = getattr(type(c), "__slots__", None)
    vals = ({k: getattr(c, k) for k in names} if names is not None
            else dict(vars(c)))
    return type(c).__qualname__, tuple(sorted(vals.items()))


def pool_snapshot(pool) -> list:
    """Every entity of an EntityPool in creation order: its id and its
    components' class names and fields in allocation order."""
    return [(e.id, [component_fields(c) for c in e._components.values()])
            for e in pool._entities.values()]


def scene_entities(sc) -> dict:
    """The Scene's entity half: the pool and the per-kind entity lists."""
    lists = ("node_entity", "renderable_entity", "decal_entity",
             "fog_region_entity", "diffuse_volume_entity")
    return {"pool": pool_snapshot(sc.entity_pool),
            **{k: [e.id for e in getattr(sc, k)] for k in lists}}


# -- tests/test_ecs.py's contract, on both pools -----------------------------

@ECS
def test_group_query_basics(E):
    pool = E.EntityPool()
    e1 = pool.create_entity()
    e2 = pool.create_entity()
    e3 = pool.create_entity()
    e1.allocate_component(A, 1)
    e1.allocate_component(B, 10)
    e2.allocate_component(A, 2)
    e3.allocate_component(B, 30)
    ab = pool.get_component_group(A, B)
    assert len(ab) == 1 and ab[0][1].v == 1 and ab[0][2].v == 10
    assert [x[1].v for x in pool.get_component_group(A)] == [1, 2]
    # a group's tuples follow the query's type order, cached or not
    ba = pool.get_component_group(B, A)
    assert (ba[0][1].v, ba[0][2].v) == (10, 1)


@ECS
def test_group_updates_on_add_remove(E):
    pool = E.EntityPool()
    e1 = pool.create_entity()
    e1.allocate_component(A)
    assert len(pool.get_component_group(A, B)) == 0
    e1.allocate_component(B)
    assert len(pool.get_component_group(A, B)) == 1
    e1.free_component(A)
    assert len(pool.get_component_group(A, B)) == 0
    assert len(pool.get_component_group(B)) == 1
    assert not e1.has_component(A) and e1.get_component(A) is None


@ECS
def test_delete_entity_removes_from_groups(E):
    pool = E.EntityPool()
    es = [pool.create_entity() for _ in range(4)]
    for e in es:
        e.allocate_component(A)
        e.allocate_component(C)
    assert len(pool.get_component_group(A, C)) == 4
    pool.delete_entity(es[1])
    assert [g[0].id for g in pool.get_component_group(A, C)] == [1, 3, 4]
    assert len(pool) == 3
    # ids are never reused
    assert pool.create_entity().id == 5


@ECS
def test_component_replacement_keeps_single_entry(E):
    pool = E.EntityPool()
    e = pool.create_entity()
    e.allocate_component(A, 1)
    e.allocate_component(A, 2)     # replace, not duplicate
    g = pool.get_component_group(A)
    assert len(g) == 1 and g[0][1].v == 2


def test_seeded_pool_operations_match():
    """One seeded sequence of create / allocate / free / delete / query on
    both pools: the same snapshots and group results after every step."""
    rng = np.random.default_rng(RNG_SEED)
    pools = JE.EntityPool(), TE.EntityPool()
    ents = ([], [])
    kinds = (A, B, C)
    for step in range(300):
        op = int(rng.integers(0, 6))
        pick = int(rng.integers(0, 1 << 30))
        t = kinds[int(rng.integers(0, 3))]
        v = int(rng.integers(0, 100))
        for pool, es in zip(pools, ents):
            live = [e for e in es if e.id in pool._entities]
            if op == 0 or not live:
                es.append(pool.create_entity())
            elif op in (1, 2):
                e = live[pick % len(live)]
                e.allocate_component(t, *(() if t is C else (v,)))
            elif op == 3:
                live[pick % len(live)].free_component(t)
            elif op == 4:
                pool.delete_entity(live[pick % len(live)])
        got = []
        for pool in pools:
            groups = [[(g[0].id, *(component_fields(c) for c in g[1:]))
                       for g in pool.get_component_group(*q)]
                      for q in ((A,), (A, B), (B, C), (C, A, B))]
            got.append((pool_snapshot(pool), groups, len(pool)))
        assert got[0] == got[1], step


# -- the Scene's entity half ---------------------------------------------------

@SCENES
def test_scene_is_backed_by_ecs(S):
    """tests/test_ecs.py::test_scene_is_backed_by_ecs on both Scenes."""
    s = S.Scene()
    n0 = s.create_node()
    n1 = s.create_node(parent=n0)
    s.add_renderable(n0, 0, S.RENDERABLE_OPAQUE | S.RENDERABLE_CASTS_SHADOW,
                     [-1, -1, -1], [1, 1, 1])
    s.add_renderable(n1, 1, S.RENDERABLE_TRANSPARENT,
                     [-1, -1, -1], [1, 1, 1])
    nodes = s.entity_pool.get_component_group(S.TransformComponent)
    assert [t.node for (_e, t) in nodes] == [n0, n1]
    opaque = s.entity_pool.get_component_group(S.RenderableComponent,
                                               S.OpaqueComponent)
    assert [r.row for (_e, r, _t) in opaque] == [0]
    trans = s.entity_pool.get_component_group(S.RenderableComponent,
                                              S.TransparentComponent)
    assert [r.row for (_e, r, _t) in trans] == [1]
    row = trans[0][1].row
    assert (s.r_flags[row] & S.RENDERABLE_TRANSPARENT) != 0


def _build(S, rng_seed: int):
    """Nodes (more than the initial capacity), renderables of every flag
    mix (opaque, transparent, shadow-casting, dynamic), decals, fog
    regions and diffuse volumes, interleaved, from one seed."""
    rng = np.random.default_rng(rng_seed)
    s = S.Scene()
    for i in range(80):
        parent = int(rng.integers(-1, i)) if i else -1
        s.create_node(parent=parent, translation=rng.normal(size=3),
                      scale=rng.uniform(0.5, 2, size=3))
        k = int(rng.integers(0, 8))
        node = int(rng.integers(0, i + 1))
        if k < 4:
            mn = rng.normal(size=3)
            s.add_renderable(node, int(rng.integers(0, 9)),
                             int(rng.integers(0, 16)), mn, mn + 1.0)
        elif k == 4:
            s.create_volumetric_decal(node, int(rng.integers(0, 3)))
        elif k == 5:
            s.create_volumetric_fog_region(
                node, None if rng.integers(0, 2) else
                rng.uniform(0, 1, (2, 3, 4)).astype(np.float32))
        elif k == 6:
            s.create_volumetric_diffuse_light(
                tuple(int(r) for r in rng.integers(1, 9, size=3)), node)
    return s


@pytest.mark.parametrize("seed", [RNG_SEED, RNG_SEED + 1])
def test_scene_entities_match(seed):
    """The same scene built through both Scene classes: entity ids,
    component types and fields entity by entity, the per-kind lists, and
    every component group the JAX Scene populates."""
    a, b = _build(TS, seed), _build(JS, seed)
    ea, eb = scene_entities(a), scene_entities(b)
    assert ea == eb
    assert len(ea["renderable_entity"]) > 10 and ea["decal_entity"] \
        and ea["fog_region_entity"] and ea["diffuse_volume_entity"]
    for names in GROUPS:
        ga = a.entity_pool.get_component_group(
            *(getattr(TS, n) for n in names))
        gb = b.entity_pool.get_component_group(
            *(getattr(JS, n) for n in names))
        assert [(g[0].id, *map(component_fields, g[1:])) for g in ga] == \
            [(g[0].id, *map(component_fields, g[1:])) for g in gb], names
    # every flag bit has its tag component, row for row
    for flag, tag in ((TS.RENDERABLE_OPAQUE, TS.OpaqueComponent),
                      (TS.RENDERABLE_TRANSPARENT, TS.TransparentComponent),
                      (TS.RENDERABLE_CASTS_SHADOW, TS.CastsShadowComponent),
                      (TS.RENDERABLE_DYNAMIC, TS.DynamicComponent)):
        rows = [r.row for _e, r, _t in a.entity_pool.get_component_group(
            TS.RenderableComponent, tag)]
        assert rows == list(np.nonzero(a.r_flags & flag)[0])
