"""Entity-component system (copy of granite_tpu/scene/ecs.py, unchanged
code; reference: ecs/ecs.{hpp,cpp}).

The reference allocates components from object pools and caches
`EntityGroup` query results per component-set hash, updating groups
incrementally on component add/remove (ecs.hpp:130, 209).  Here:

  * entities are integer ids; components live in per-type dicts
    entity -> component (insertion-ordered, so iteration is deterministic);
  * group queries are cached per component-type tuple and invalidated
    incrementally on add/remove, like the reference;
  * numpy-SoA "component arrays" are exposed for hot data (see scene.py)
    while the ECS handles identity/lifetime — the reference splits the
    same way (ComponentAllocator pools + per-frame SoA gathers).
"""

from __future__ import annotations

from typing import Iterable, Type, TypeVar

T = TypeVar("T")


class Entity:
    __slots__ = ("id", "_pool", "_components")

    def __init__(self, eid: int, pool: "EntityPool"):
        self.id = eid
        self._pool = pool
        self._components: dict[type, object] = {}

    def allocate_component(self, comp_type: Type[T], *args, **kw) -> T:
        comp = comp_type(*args, **kw)
        had = comp_type in self._components
        self._components[comp_type] = comp
        if not had:
            self._pool._component_added(self, comp_type)
        return comp

    def free_component(self, comp_type: type) -> None:
        if comp_type in self._components:
            del self._components[comp_type]
            self._pool._component_removed(self, comp_type)

    def get_component(self, comp_type: Type[T]) -> T | None:
        return self._components.get(comp_type)

    def has_component(self, comp_type: type) -> bool:
        return comp_type in self._components


class EntityPool:
    """ecs.hpp EntityPool + group cache."""

    def __init__(self):
        self._entities: dict[int, Entity] = {}
        self._next_id = 1
        # component type -> {entity id -> Entity}
        self._by_type: dict[type, dict[int, Entity]] = {}
        # cached groups: tuple(types) -> list[Entity] (None = dirty)
        self._groups: dict[tuple, list | None] = {}

    def create_entity(self) -> Entity:
        e = Entity(self._next_id, self)
        self._entities[e.id] = e
        self._next_id += 1
        return e

    def delete_entity(self, e: Entity) -> None:
        for t in list(e._components):
            e.free_component(t)
        self._entities.pop(e.id, None)

    def _component_added(self, e: Entity, t: type) -> None:
        self._by_type.setdefault(t, {})[e.id] = e
        for key in self._groups:
            if t in key:
                self._groups[key] = None

    def _component_removed(self, e: Entity, t: type) -> None:
        self._by_type.get(t, {}).pop(e.id, None)
        for key in self._groups:
            if t in key:
                self._groups[key] = None

    def get_component_group(self, *types: type) -> list[tuple]:
        """All (entity, comp...) tuples with every listed component.
        Cached per type-set; rebuilt lazily after invalidation."""
        key = tuple(sorted(types, key=lambda t: t.__qualname__))
        cached = self._groups.get(key)
        if cached is None or key not in self._groups:
            smallest = min(
                (self._by_type.get(t, {}) for t in key),
                key=len, default={})
            out = []
            for e in smallest.values():
                if all(t in e._components for t in key):
                    out.append(e)
            self._groups[key] = out
            cached = out
        return [(e, *(e._components[t] for t in types)) for e in cached]

    def __len__(self) -> int:
        return len(self._entities)
