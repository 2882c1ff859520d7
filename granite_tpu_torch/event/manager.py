"""Port (host copy, unchanged code) of granite_tpu/event/manager.py.

Event bus with immediate + latched events (reference: event/event.hpp).

Granite's EventManager (event/event.hpp:112) supports:
  * immediate events: enqueue + dispatch to registered handlers
    (EVENT_MANAGER_REGISTER, event.hpp:33),
  * **latched** events (EVENT_MANAGER_REGISTER_LATCH, event.hpp:38): fired
    "up" and later "down"; handlers registered AFTER an up-event replay it
    immediately (e.g. DeviceCreated) — see OVERVIEW.md event section.

Same semantics here, keyed by event class.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Optional, Type


class Event:
    """Base event; subclass and add fields."""


class LatchedEvent(Event):
    """Base for latched events (paired begin/end lifecycle)."""


class EventManager:
    _instance: Optional["EventManager"] = None

    def __init__(self):
        self._handlers: dict[type, list[Callable]] = defaultdict(list)
        self._latch_up: dict[type, list[Callable]] = defaultdict(list)
        self._latch_down: dict[type, list[Callable]] = defaultdict(list)
        self._latched: dict[type, list[Event]] = defaultdict(list)
        self._queued: list[Event] = []

    @classmethod
    def get(cls) -> "EventManager":
        if cls._instance is None:
            cls._instance = EventManager()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None

    # -- immediate events ----------------------------------------------------
    def register_handler(self, event_type: Type[Event],
                         handler: Callable[[Event], None]) -> None:
        self._handlers[event_type].append(handler)

    def unregister_handler(self, event_type: Type[Event],
                           handler: Callable) -> None:
        if handler in self._handlers.get(event_type, []):
            self._handlers[event_type].remove(handler)

    def enqueue(self, event: Event) -> None:
        self._queued.append(event)

    def dispatch(self) -> None:
        """Drain the queue (called from Application::poll)."""
        queued, self._queued = self._queued, []
        for ev in queued:
            self.dispatch_inline(ev)

    def dispatch_inline(self, event: Event) -> None:
        for h in self._handlers.get(type(event), []):
            h(event)

    # -- latched events ------------------------------------------------------
    def register_latch_handler(self, event_type: Type[LatchedEvent],
                               up: Callable, down: Callable) -> None:
        self._latch_up[event_type].append(up)
        self._latch_down[event_type].append(down)
        # Replay already-latched events to the late registrant.
        for ev in self._latched.get(event_type, []):
            up(ev)

    def enqueue_latched(self, event: LatchedEvent) -> None:
        self._latched[type(event)].append(event)
        for h in self._latch_up.get(type(event), []):
            h(event)

    def dequeue_all_latched(self, event_type: Type[LatchedEvent]) -> None:
        for ev in self._latched.get(event_type, []):
            for h in self._latch_down.get(event_type, []):
                h(ev)
        self._latched[event_type] = []
