"""Chrome-trace JSON profiler (copy of granite_tpu/utils/timeline_trace.py;
reference: util/timeline_trace_file.hpp:35-92).

The reference records per-thread begin/end events into a dedicated writer
thread and emits a chrome://tracing JSON file; scopes are declared with
GRANITE_SCOPED_TIMELINE_EVENT.  We reproduce the same event format so traces
open in Perfetto, and additionally let callers inject explicit device
timings (the render graph's per-pass times) as complete events.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional


class TimelineTraceFile:
    _instance: Optional["TimelineTraceFile"] = None

    def __init__(self, path: str):
        self._path = path
        self._events = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._t0 = time.monotonic_ns()

    @classmethod
    def set_instance(cls, inst: Optional["TimelineTraceFile"]) -> None:
        cls._instance = inst

    @classmethod
    def get_instance(cls) -> Optional["TimelineTraceFile"]:
        return cls._instance

    def _now_us(self) -> float:
        return (time.monotonic_ns() - self._t0) / 1000.0

    def begin_event(self, name: str, tid: Optional[int] = None) -> None:
        with self._lock:
            self._events.append({
                "name": name, "ph": "B", "ts": self._now_us(),
                "pid": self._pid, "tid": tid or threading.get_ident() % 1_000_000,
            })

    def end_event(self, tid: Optional[int] = None) -> None:
        with self._lock:
            self._events.append({
                "ph": "E", "ts": self._now_us(),
                "pid": self._pid, "tid": tid or threading.get_ident() % 1_000_000,
            })

    def complete_event(self, name: str, start_us: float, dur_us: float,
                       tid: int = 0, args: Optional[dict] = None) -> None:
        """Inject an externally-timed event (e.g. device time for a pass)."""
        ev = {"name": name, "ph": "X", "ts": start_us, "dur": dur_us,
              "pid": self._pid, "tid": tid}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def flush(self) -> None:
        with self._lock:
            with open(self._path, "w") as f:
                json.dump({"traceEvents": self._events}, f)

    def __del__(self):
        try:
            self.flush()
        except Exception:
            pass


@contextmanager
def scoped_timeline_event(name: str):
    """Python analogue of GRANITE_SCOPED_TIMELINE_EVENT."""
    tf = TimelineTraceFile.get_instance()
    if tf is None:
        yield
        return
    tf.begin_event(name)
    try:
        yield
    finally:
        tf.end_event()
