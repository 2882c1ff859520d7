"""Stat aggregation and the headless stat JSON (copy of
granite_tpu/core/stats.py; reference:
application/platforms/application_headless.cpp:638-653).

The schema {averageFrameTimeUs, gpu, version, frames,
performanceCounters, passTimesUs} is the JAX engine's, so sweep and
compare tooling reads both engines' stat files unchanged.
"""

from __future__ import annotations

import json
from collections import defaultdict


class TimestampIntervalStats:
    """Named interval accumulation (vulkan/query_pool.hpp:133,200)."""

    def __init__(self):
        self._total = defaultdict(float)
        self._count = defaultdict(int)

    def accumulate(self, tag: str, seconds: float) -> None:
        self._total[tag] += seconds
        self._count[tag] += 1

    def averages_us(self) -> dict[str, float]:
        return {t: 1e6 * self._total[t] / max(self._count[t], 1)
                for t in self._total}

    def reset(self) -> None:
        self._total.clear()
        self._count.clear()


class StatSink:
    def __init__(self, gpu_name: str, version: str = "granite_tpu_torch-0.1"):
        self.gpu_name = gpu_name
        self.version = version
        self.total_frame_time_s = 0.0
        self.frames = 0
        self.intervals = TimestampIntervalStats()
        self.counters: dict[str, float] = {}

    def add_frame(self, seconds: float) -> None:
        self.total_frame_time_s += seconds
        self.frames += 1

    def average_frame_time_us(self) -> float:
        return 1e6 * self.total_frame_time_s / max(self.frames, 1)

    def to_dict(self) -> dict:
        return {
            "averageFrameTimeUs": self.average_frame_time_us(),
            "gpu": self.gpu_name,
            "version": self.version,
            "frames": self.frames,
            "performanceCounters": dict(self.counters),
            "passTimesUs": self.intervals.averages_us(),
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
