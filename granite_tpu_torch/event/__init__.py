from .manager import Event, EventManager, LatchedEvent
