"""Asset streaming with residency budget (copy of
granite_tpu/filesystem/asset_manager.py; reference:
filesystem/asset_manager.{hpp,cpp}).

Granite's AssetManager registers assets (AssetID), classes them with
fallback substitutes (AssetClass, asset_manager.hpp:51-66), keeps an LRU
residency set under a cost budget (set_asset_budget), and per frame
`iterate()` spawns instantiation tasks on the thread group; instantiated
views are latched once per frame (ResourceManager::latch_handles).

Here "instantiate" = decode on a worker thread into a host array (the
frame loop uploads it); the budget is decoded bytes.  Consumers read
get_asset(id) which returns the resident payload or the class fallback.

One deliberate change: a worker's exception is kept and re-raised by the
next iterate(), after the finished assets are published (the failed
asset is requested again at its next get_asset).  The original runs the
instantiation inside a thread-pool future that no one reads, so the
exception is lost and the asset stays pending, rendering its fallback
forever.  `evictions` counts the assets evicted so far.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..utils.logging import LOGI
from ..threading_.thread_group import TaskClass, ThreadGroup

AssetID = int


class AssetClass(enum.Enum):
    """asset_manager.hpp:51-66 — fallback substitute per class."""
    ZEROABLE = 0          # fallback: zeros / transparent-black
    COLOR = 1             # fallback: white
    NORMAL = 2            # fallback: flat normal
    METALLIC_ROUGHNESS = 3
    MESH = 4


@dataclass
class _Asset:
    id: AssetID
    path: str
    asset_class: AssetClass
    cost: int = 0
    resident: bool = False
    pending: bool = False
    requested: bool = False
    payload: Any = None
    last_used: int = 0
    prio: int = 0


class AssetInstantiatorInterface:
    """asset_manager.hpp:71: decode+upload hook."""

    def instantiate(self, path: str, asset_class: AssetClass) -> tuple:
        """Returns (payload, cost_bytes)."""
        raise NotImplementedError

    def fallback(self, asset_class: AssetClass) -> Any:
        return None

    def release(self, payload: Any) -> None:
        pass


class AssetManager:
    MAX_ASSETS = 1 << 18     # asset_manager.hpp:39

    def __init__(self, instantiator: AssetInstantiatorInterface,
                 thread_group: Optional[ThreadGroup] = None):
        self._inst = instantiator
        self._tg = thread_group or ThreadGroup.get()
        self._assets: list[_Asset] = []
        self._by_path: dict[str, AssetID] = {}
        self._budget = 1 << 62
        self._timestamp = 0
        self._lock = threading.Lock()
        self._total_cost = 0
        self._completed: list[tuple[AssetID, Any, int]] = []
        self._failed: list[tuple[AssetID, BaseException]] = []
        self.evictions = 0

    # -- registration ----------------------------------------------------------
    def register_asset(self, path: str,
                       asset_class: AssetClass = AssetClass.COLOR,
                       prio: int = 0) -> AssetID:
        if path in self._by_path:
            return self._by_path[path]
        if len(self._assets) >= self.MAX_ASSETS:
            raise RuntimeError("asset table full")
        aid = len(self._assets)
        self._assets.append(_Asset(aid, path, asset_class, prio=prio))
        self._by_path[path] = aid
        return aid

    def set_asset_budget(self, bytes_: int) -> None:
        self._budget = bytes_

    def set_asset_residency_priority(self, aid: AssetID, prio: int) -> None:
        self._assets[aid].prio = prio

    # -- per-frame -----------------------------------------------------------------
    def mark_used(self, aid: AssetID) -> None:
        self._assets[aid].last_used = self._timestamp

    def is_resident(self, aid: AssetID) -> bool:
        return self._assets[aid].resident

    def get_asset(self, aid: AssetID):
        """Resident payload or class fallback (draw-time consumer)."""
        a = self._assets[aid]
        a.last_used = self._timestamp
        if a.resident:
            return a.payload
        a.requested = True
        return self._inst.fallback(a.asset_class)

    def iterate(self) -> None:
        """Streaming decisions for one frame (AssetManager::iterate,
        asset_manager.hpp:118): publish finished uploads, evict LRU over
        budget, kick instantiation of wanted assets under budget."""
        self._timestamp += 1

        with self._lock:
            completed, self._completed = self._completed, []
            failed, self._failed = self._failed, []
        for aid, payload, cost in completed:
            a = self._assets[aid]
            a.payload = payload
            a.cost = cost
            a.resident = True
            a.pending = False
            self._total_cost += cost
        for aid, _err in failed:
            self._assets[aid].pending = False
        if failed:
            aid, err = failed[0]
            err.add_note(f"while instantiating asset {self._assets[aid].path}")
            raise err

        # Evict least-recently-used until under budget.
        if self._total_cost > self._budget:
            resident = sorted((a for a in self._assets if a.resident),
                              key=lambda a: (a.prio, a.last_used))
            for a in resident:
                if self._total_cost <= self._budget:
                    break
                self._inst.release(a.payload)
                a.payload = None
                a.resident = False
                self._total_cost -= a.cost
                self.evictions += 1
                LOGI("asset evicted: %s (%d bytes)", a.path, a.cost)

        # Kick pending instantiations for requested assets.
        for a in self._assets:
            if a.resident or a.pending or not a.requested:
                continue
            if self._total_cost >= self._budget:
                break
            a.requested = False
            a.pending = True
            self._tg.create_task(
                self._make_instantiate(a), name=f"asset:{a.path}",
                task_class=TaskClass.BACKGROUND).flush()

    def _make_instantiate(self, a: _Asset) -> Callable:
        def run():
            try:
                payload, cost = self._inst.instantiate(a.path,
                                                       a.asset_class)
            except Exception as err:  # noqa: BLE001 - re-raised by iterate()
                with self._lock:
                    self._failed.append((a.id, err))
                return
            with self._lock:
                self._completed.append((a.id, payload, cost))
        return run

    @property
    def current_cost(self) -> int:
        return self._total_cost
