"""Render-graph debug execution: breadcrumbs + validation mode (port of
granite_tpu/graph/debug.py).

Reference analogues:
  * breadcrumbs (vulkan/breadcrumbs.{hpp,cpp}): buffer-marker trails
    recording every draw/dispatch; on device loss the last-known-good
    marker is dumped.  Here: debug execution runs the baked graph pass by
    pass and synchronizes the device after each, so a kernel fault (or a
    NaN, with check_numerics) maps to the exact pass name.
  * validation layers: `check_numerics=True` scans every pass's floating
    outputs for NaN/Inf (non-fatal: the pass is flagged and logged).
  * per-pass timing: the QueryPool timestamp path (query_pool.hpp:133):
    each pass's milliseconds, host clock around the pass and its
    synchronize, go to `device.register_time_interval` (a
    core.device.Device, the app's hub) as `pass:<name>`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..utils.logging import LOGE
from .render_graph import RenderGraphError


@dataclass
class Breadcrumbs:
    """Pass trail of the most recent debug execution."""
    completed: list = field(default_factory=list)
    failed: str | None = None
    nan_passes: list = field(default_factory=list)
    pass_times_ms: dict = field(default_factory=dict)

    def report(self) -> str:
        lines = ["RenderGraph breadcrumb trail:"]
        for name in self.completed:
            t = self.pass_times_ms.get(name)
            flag = " [NaN/Inf!]" if name in self.nan_passes else ""
            lines.append(f"  [done] {name}"
                         + (f" ({t:.2f} ms)" if t is not None else "")
                         + flag)
        if self.failed:
            lines.append(f"  [FAULT] {self.failed}  <-- device fault here")
        return "\n".join(lines)


def _synchronize(outs: dict) -> None:
    for dev in {v.device for v in outs.values()
                if isinstance(v, torch.Tensor) and v.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def execute_debug(graph, params, history, check_numerics: bool = True,
                  device=None) -> tuple:
    """Run the baked graph one pass at a time, synchronizing the device
    after each.  -> (backbuffer, new_history, breadcrumbs).  Much slower
    than graph.execute (a host round trip every pass, and a scan of every
    output with check_numerics): a debugging tool."""
    if not graph._order:
        raise RenderGraphError("graph not baked")
    crumbs = Breadcrumbs()
    pool: dict = {}
    for pname in graph._order:
        t0 = time.monotonic_ns()
        try:
            outs = graph.run_pass(pname, pool, history, params)
            # Force completion so faults attribute to THIS pass.
            _synchronize(outs)
        except Exception:  # noqa: BLE001 - report the trail, then re-raise
            crumbs.failed = pname
            LOGE("%s", crumbs.report())
            raise
        dt_ms = (time.monotonic_ns() - t0) / 1e6
        crumbs.pass_times_ms[pname] = dt_ms
        if device is not None:
            device.register_time_interval(f"pass:{pname}", dt_ms / 1e3)
        if check_numerics:
            for k, v in outs.items():
                if v.is_floating_point() and not bool(v.isfinite().all()):
                    crumbs.nan_passes.append(pname)
                    LOGE("pass '%s' output '%s' contains NaN/Inf", pname, k)
                    break
        crumbs.completed.append(pname)
    new_history = {n: pool[n] for n in graph._history_resources}
    return pool[graph._backbuffer], new_history, crumbs
