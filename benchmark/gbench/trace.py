"""Device-side readings of a traced stretch of frames, from torch.profiler:
the busy time (the union of kernel, copy and set intervals on the card),
the `pass:<name>` ranges' device time, each kernel's calls, and the idle
gaps labelled by what the host was doing.  The lost-frame retrace is
frozen from chip_smoke.device_busy_ms at commit 757dbb804350: a trace
that kept fewer of the graph's last pass ranges than frames it ran lost
a frame's events and is taken again, up to TRACE_ATTEMPTS times; so is
one whose card time disagrees with the card-only trace's by more than
BUSY_AGREE (the profiler can map a trace's card clock wrongly: a 2160p
trace once read every kernel 26% short, B4 at 111% of its bound).  Where
no attempt agrees, `device_ok` is False and the readers of kernel and
range times report nothing."""

from __future__ import annotations

import time

TRACE_ATTEMPTS = 3
BUSY_AGREE = 0.1


def _named(name: str) -> bool:
    return name.startswith("pass:") or name.startswith("bench:") \
        or name == "decals"


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def traced(run_frames, frames: int, last_pass: str) -> dict:
    """Trace run_frames(frames) twice -> readings (times in ms unless
    named _s).  The first trace records the card alone (no host-side
    event, so the profiler barely slows the host): the busy time and the
    window.  The second records host and card, for the pass ranges, the
    kernels' calls and what the host did in each idle gap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_frames(frames)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    on_card = [(ev.time_range.start, ev.time_range.end)
               for ev in prof.events() if ev.device_type == DeviceType.CUDA
               and not _named(ev.name)]
    if not on_card:
        raise RuntimeError("the trace holds no device operation")
    busy_s = _union(on_card) / 1e6
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_frames(frames)
            torch.cuda.synchronize()
        events = prof.events()
        kept = sum(1 for ev in events if ev.device_type == DeviceType.CPU
                   and ev.name == f"pass:{last_pass}")
        busy2_s = _union([(ev.time_range.start, ev.time_range.end)
                          for ev in events
                          if ev.device_type == DeviceType.CUDA
                          and not _named(ev.name)]) / 1e6
        device_ok = abs(busy2_s / busy_s - 1.0) <= BUSY_AGREE
        if kept == frames and device_ok:
            break
    if kept != frames:
        raise RuntimeError(f"no trace kept all {frames} frames "
                           f"(the last kept {kept})")
    ranges: dict = {}
    host_spans = []
    device = []
    for ev in events:
        if ev.device_type == DeviceType.CPU and _named(ev.name):
            if ev.name.startswith("pass:") or ev.name == "decals":
                ranges[ev.name] = ranges.get(ev.name, 0.0) \
                    + ev.device_time_total / 1e3 / frames
            host_spans.append((ev.time_range.start, ev.time_range.end,
                               ev.name))
        elif ev.device_type == DeviceType.CUDA and not _named(ev.name):
            device.append((ev.time_range.start, ev.time_range.end, ev.name))
    if not device:
        raise RuntimeError("the trace holds no device operation")
    device.sort()
    by_name: dict = {}
    for a, b, n in device:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    gaps = []
    end = device[0][1]
    for a, b, _n in device[1:]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    labelled: dict = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = [(s1 - s0, n) for s0, s1, n in host_spans if s0 <= mid <= s1]
        label = min(inner)[1] if inner else "host: outside the viewer's calls"
        labelled[label] = labelled.get(label, 0.0) + (g1 - g0)
    return {"frames": frames, "window_s": window_s, "busy_s": busy_s,
            "busy2_s": busy2_s, "device_ok": device_ok,
            "ranges_ms": ranges, "device": device,
            "device_ops": sorted(((n, t / 1e6) for n, t in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(((n, t / 1e6) for n, t in labelled.items()),
                                key=lambda x: -x[1])[:10]}


def kernel_calls(reading: dict, fragment: str) -> list:
    """Device ms of each call of the kernels whose names hold fragment;
    none where the trace's card times are not to be trusted."""
    if not reading["device_ok"]:
        return []
    return [(b - a) / 1e3 for a, b, n in reading["device"] if fragment in n]


def range_ms(reading: dict, name: str):
    """Device ms a frame of a pass range, or None (no such range, or card
    times not to be trusted)."""
    if not reading["device_ok"]:
        return None
    return reading["ranges_ms"].get(name)
