"""Spans and counters of the frame path, on torch.profiler's clock.

    with span("params"): ...       # frame:params, outside the graph
    with span("raster.bin"): ...   # pass:<p>/raster.bin inside pass <p>
    with readback("bin.huge_dst", t): idx = t[mask]
    t = upload(array, device=dev)  # counted in uploads, upload_bytes
                                   # (and uploads_staged, see upload)
    count("name", n)

Off (the default: no profiler running, no recorder on) a span is one
flag test and torch.profiler's enabled check, and opens nothing.

Under torch.profiler a span opens a range under its full name on the
profiler's timeline, where the kernels it launches lie too, so each idle
gap of the card can be put down to the innermost span the host was in.
`pass:*` names (and `decals`) open a `record_function` range, which also
puts an annotation of the same name on the card's timeline: a reader of
the trace tells those annotations from device work by their `pass:`
prefix.  `frame:*` names open a host-only range (a `_RecordFunctionFast`,
no device annotation), so no reader of the trace counts them as work on
the card.  Counters are not sent to the profiler.

A FrameRecorder, switched on by entering it (`with FrameRecorder(hub) as
rec:`), keeps each span's name, parent, frame id (`hub.frame_counter`
when the span opens) and start and end on time.perf_counter_ns (the
host clock), and each counter's value a frame; `rec.frames()` gives, a
frame, each span name's total and self ms (its time less its children's)
and the counters.

Naming.  `pass:<name>` (the render graph's range of a pass) and `decals`
keep their names.  Any other name is a stage: inside a pass it is named
`pass:<pass>/<stage>` whatever stages lie between (stage code such as
the raster is shared by the forward and G-buffer passes); outside the
graph it is `frame:<stage>`, or `<enclosing stage>/<stage>` when nested
(`frame:params/cull`).  `frame:render`, the whole `render_frame` call, is
given whole and prefixes nothing.  A readback is the stage
`readback.<site>`.
"""

from __future__ import annotations

import time

import torch

ROOT = "frame:render"

_profiler_enabled = torch._C._autograd._profiler_enabled
_host_range = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_recorder = None    # the FrameRecorder switched on, or None
_arena = None       # the staging arena upload() uses (stage_through)
# The open spans of the frame path (one thread), outermost first: their
# full names and recorder indices (-1: not recorded).
_names: list = []
_idx: list = []


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def full_name(name: str, stack=()) -> str:
    """The name a span opened as `name` takes under the open spans
    `stack` (outermost first)."""
    if ":" in name or name == "decals":
        return name
    for full in reversed(stack):
        if full.startswith("pass:"):
            return full.split("/", 1)[0] + "/" + name
    for full in reversed(stack):
        if full.startswith("frame:") and full != ROOT:
            return full + "/" + name
    return "frame:" + name


class _Span:
    __slots__ = ("full", "rf", "idx")

    def __init__(self, name: str):
        self.full = name

    def __enter__(self):
        full = self.full = full_name(self.full, _names)
        self.rf = None
        if _profiler_enabled():
            if full.startswith("frame:"):
                if _host_range is not None:
                    self.rf = _host_range(full)
            else:
                self.rf = torch.profiler.record_function(full)
            if self.rf is not None:
                self.rf.__enter__()
        rec = _recorder
        self.idx = rec._open(full, _idx[-1] if _idx else -1) \
            if rec is not None else -1
        _names.append(full)
        _idx.append(self.idx)
        return None

    def __exit__(self, *exc):
        _names.pop()
        _idx.pop()
        if self.idx >= 0 and _recorder is not None:
            _recorder._close(self.idx)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one stage of the frame (see the module's
    naming rule); opens nothing when off."""
    if _recorder is None and not _profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to this frame's counter `name` (kept only by a recorder)."""
    if _recorder is not None:
        _recorder._add(name, n)


def readback(site: str, t: torch.Tensor):
    """A host read of tensor t at `site` (an int() or bool() of it,
    .item(), .tolist(), .cpu(), nonzero, a boolean-mask index): counted
    in `readbacks` and spanned as `readback.<site>` when t is on a CUDA
    device; a CPU tensor's read is no readback."""
    if _recorder is None and not _profiler_enabled():
        return _OFF
    if t.device.type != "cuda":
        return _OFF
    count("readbacks")
    return _Span("readback." + site)


def upload(a, dtype=None, device=None) -> torch.Tensor:
    """torch.as_tensor(a, dtype, device), counted in `uploads` and
    `upload_bytes` when it copies host data to a CUDA device.  Host data
    bound for the device of the frame ring's current staging arena
    (core/device.StagingArena) goes through it when it fits: copied into
    pinned memory and on to a fresh device tensor without blocking, and
    counted in `uploads_staged` too; any other upload (a CPU target, no
    ring yet, no room left in the slot) is the blocking copy."""
    arena = _arena
    if arena is not None and device == arena.device:
        t = arena.stage(a, dtype)
        if t is not None:
            if _recorder is not None:
                _recorder._add("uploads", 1)
                _recorder._add("upload_bytes", t.nbytes)
                _recorder._add("uploads_staged", 1)
            return t
    t = torch.as_tensor(a, dtype=dtype, device=device)
    if _recorder is not None and t.device.type == "cuda" and not (
            isinstance(a, torch.Tensor) and a.device.type == "cuda"):
        _recorder._add("uploads", 1)
        _recorder._add("upload_bytes", t.nbytes)
    return t


def stage_through(arena) -> None:
    """Make `arena` (a core/device.StagingArena, or None) the one upload()
    stages through: the frame ring's current slot's."""
    global _arena
    _arena = arena


class FrameRecorder:
    """The frame path's spans and counters, kept in memory while the
    recorder is entered (one at a time).  hub: anything with a
    `frame_counter` (core/device.Device), read as the frame id."""

    def __init__(self, hub):
        self.hub = hub
        self.spans: list = []      # [name, parent index, frame, t0, t1] ns
        self.counters: dict = {}   # frame -> {name: value}

    def __enter__(self) -> "FrameRecorder":
        global _recorder
        if _recorder is not None:
            raise RuntimeError("a FrameRecorder is already on")
        _recorder = self
        return self

    def __exit__(self, *exc):
        global _recorder
        _recorder = None
        return False

    def _open(self, name: str, parent: int) -> int:
        self.spans.append([name, parent, int(self.hub.frame_counter),
                           time.perf_counter_ns(), None])
        return len(self.spans) - 1

    def _close(self, idx: int) -> None:
        self.spans[idx][4] = time.perf_counter_ns()

    def _add(self, name: str, n: int) -> None:
        c = self.counters.setdefault(int(self.hub.frame_counter), {})
        c[name] = c.get(name, 0) + n

    def frames(self) -> list:
        """-> one dict a frame id, in order: {"frame", "total_ms" {name:
        ms}, "self_ms" {name: ms}, "counters" {name: value}}; spans left
        open are left out."""
        child_ns = [0] * len(self.spans)
        for name, parent, frame, t0, t1 in self.spans:
            if parent >= 0 and t1 is not None:
                child_ns[parent] += t1 - t0
        out: dict = {}
        for i, (name, parent, frame, t0, t1) in enumerate(self.spans):
            if t1 is None:
                continue
            f = out.setdefault(frame, {"frame": frame, "total_ms": {},
                                       "self_ms": {}, "counters": {}})
            f["total_ms"][name] = f["total_ms"].get(name, 0.0) \
                + (t1 - t0) / 1e6
            f["self_ms"][name] = f["self_ms"].get(name, 0.0) \
                + (t1 - t0 - child_ns[i]) / 1e6
        for frame, c in self.counters.items():
            out.setdefault(frame, {"frame": frame, "total_ms": {},
                                   "self_ms": {}, "counters": {}})[
                "counters"] = dict(c)
        return [out[k] for k in sorted(out)]
