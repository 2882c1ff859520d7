"""Host-side task graph (copy of granite_tpu/threading_/thread_group.py;
reference: threading/thread_group.hpp:152 + threading/task_composer.hpp:30).

The reference runs foreground/background worker pools with dependency-
chained TaskGroups.  Here they cover the host work of the frame loop:
asset decode and scene prep.  Workers never touch a CUDA tensor; they
return numpy arrays, and the frame loop uploads them.
ThreadPoolExecutor-backed with the same API shape:

    tg = ThreadGroup()
    g1 = tg.create_task(fn)
    g2 = tg.create_task(fn2)
    g2.add_dependency(g1)          # g2 runs after g1
    g2.flush(); g2.wait()

TaskComposer builds a linear pipeline of stages where each stage depends
on the previous one (task_composer.hpp:30-58).

One deliberate change: wait_idle() waits for every task submitted so far
(and the tasks they release) to finish.  The original queues one no-op a
worker and waits for those, which returns while a long task still runs
on one worker when the others take the no-ops.
"""

from __future__ import annotations

import enum
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Optional

from ..utils.environment import get_environment_int


class TaskClass(enum.Enum):
    FOREGROUND = 0
    BACKGROUND = 1


class TaskGroup:
    """A set of tasks released together once dependencies complete."""

    def __init__(self, group: "ThreadGroup", task_class: TaskClass,
                 name: str = ""):
        self._group = group
        self._class = task_class
        self.name = name
        self._tasks: list[Callable] = []
        self._deps_remaining = 0
        self._dependents: list[TaskGroup] = []
        self._flushed = False
        self._done = threading.Event()
        self._pending = 0
        self._lock = threading.Lock()

    def enqueue_task(self, fn: Callable) -> None:
        self._tasks.append(fn)

    def add_dependency(self, other: "TaskGroup") -> None:
        """This group runs only after `other` completes."""
        with other._lock:
            if not other._done.is_set():
                other._dependents.append(self)
                with self._lock:
                    self._deps_remaining += 1

    def flush(self) -> None:
        self._flushed = True
        self._maybe_submit()

    def _maybe_submit(self) -> None:
        with self._lock:
            if not self._flushed or self._deps_remaining > 0:
                return
            tasks = self._tasks
            self._tasks = []
            if not tasks:
                self._complete()
                return
            self._pending = len(tasks)
        for fn in tasks:
            self._group._submit(self._class, self._run_one, fn)

    def _run_one(self, fn: Callable) -> None:
        try:
            fn()
        finally:
            with self._lock:
                self._pending -= 1
                last = self._pending == 0
            if last:
                self._complete()

    def _complete(self) -> None:
        self._done.set()
        for dep in self._dependents:
            with dep._lock:
                dep._deps_remaining -= 1
            dep._maybe_submit()
        self._dependents = []

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def complete(self) -> bool:
        return self._done.is_set()


class ThreadGroup:
    _instance: Optional["ThreadGroup"] = None

    def __init__(self, num_workers: Optional[int] = None,
                 num_background: Optional[int] = None):
        n = num_workers or get_environment_int(
            "GRANITE_NUM_WORKER_THREADS", min(os.cpu_count() or 1, 8))
        nb = num_background or max(n // 2, 1)
        self._fg = ThreadPoolExecutor(n, thread_name_prefix="granite-fg")
        self._bg = ThreadPoolExecutor(nb, thread_name_prefix="granite-bg")
        self._lock = threading.Lock()
        self._outstanding: set = set()

    @classmethod
    def get(cls) -> "ThreadGroup":
        if cls._instance is None:
            cls._instance = ThreadGroup()
        return cls._instance

    def create_task(self, fn: Optional[Callable] = None, name: str = "",
                    task_class: TaskClass = TaskClass.FOREGROUND
                    ) -> TaskGroup:
        g = TaskGroup(self, task_class, name)
        if fn is not None:
            g.enqueue_task(fn)
        return g

    def _submit(self, task_class: TaskClass, fn, *args) -> None:
        pool = self._fg if task_class == TaskClass.FOREGROUND else self._bg
        with self._lock:
            fut = pool.submit(fn, *args)
            self._outstanding.add(fut)
        fut.add_done_callback(self._retire)

    def _retire(self, fut) -> None:
        with self._lock:
            self._outstanding.discard(fut)

    def wait_idle(self) -> None:
        """Return once every submitted task has finished.  A finishing
        task group submits its dependents before its own future
        completes, so the loop also waits for what they release."""
        while True:
            with self._lock:
                pending = list(self._outstanding)
            if not pending:
                return
            wait(pending)

    def shutdown(self) -> None:
        self._fg.shutdown(wait=True)
        self._bg.shutdown(wait=True)


class TaskComposer:
    """Linear pipeline-of-stages builder (task_composer.hpp:30-58)."""

    def __init__(self, group: Optional[ThreadGroup] = None):
        self.group = group or ThreadGroup.get()
        self._current: Optional[TaskGroup] = None

    def begin_pipeline_stage(self, name: str = "") -> TaskGroup:
        stage = self.group.create_task(name=name)
        if self._current is not None:
            stage.add_dependency(self._current)
            self._current.flush()
        self._current = stage
        return stage

    def get_group(self) -> TaskGroup:
        if self._current is None:
            self.begin_pipeline_stage()
        return self._current

    def get_outgoing_task(self) -> TaskGroup:
        out = self.get_group()
        out.flush()
        self._current = None
        return out
