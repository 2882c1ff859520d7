"""Frame timer (copy of granite_tpu/utils/timer.py; reference:
util/timer.{hpp,cpp}).  The headless runner takes each frame's time and
elapsed time from it, as the JAX runner does."""

from __future__ import annotations

import time


def get_current_time_nsecs() -> int:
    return time.monotonic_ns()


class FrameTimer:
    """Frame timing with smoothed elapsed time, mirroring Util::FrameTimer."""

    def __init__(self):
        self._start = get_current_time_nsecs()
        self._last = self._start
        self._last_period = 0.0
        self._idle_time = 0.0

    def frame(self, fixed_step: float | None = None) -> float:
        """Advance one frame; returns elapsed seconds since the last frame.

        With `fixed_step` (the headless --time-step mode,
        application_headless.cpp:469) the wall clock is ignored and the frame
        time is deterministic.
        """
        if fixed_step is not None:
            self._last_period = fixed_step
            self._last += int(fixed_step * 1e9)
            return fixed_step
        now = get_current_time_nsecs()
        self._last_period = (now - self._last) * 1e-9
        self._last = now
        return self._last_period

    def get_elapsed(self) -> float:
        return (self._last - self._start) * 1e-9 - self._idle_time

    def get_frame_time(self) -> float:
        return self._last_period

    def enter_idle(self) -> int:
        return get_current_time_nsecs()

    def leave_idle(self, enter_ts: int) -> None:
        self._idle_time += (get_current_time_nsecs() - enter_ts) * 1e-9
