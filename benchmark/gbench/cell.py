"""One run of one cell: set-up, the measured window, the traced frames,
then the comparison with the plain reference.

The timed frame is the headless runner's unchained frame with the pose
set from the cell's pose list first:
  app.camera <- pose; out = app.render_frame(1/60, elapsed);
  app.hub.frame().track(out); app.hub.next_frame_context();
  app.post_frame()
one client, closed loop, the ring's frames in flight.  The window cycles
through the pose list.  Judged frames: the window's first (its history is
the lead-in's, which the reference replays, so its backbuffer is judged
too), JUDGED_DRAWN more drawn from the seed among the first
JUDGED_WITHIN, and the window's last; their planes are kept from the
graph's pool when they are rendered and compared after the window, once
the viewer is gone.  The configuration names its reference and the maps
judged beside the frames (the contract in gbench/__init__.py).
"""

from __future__ import annotations

import gc
import importlib
import os
import time

import numpy as np
import torch

from . import judge as J
from .scene import build_scene, lens, make_viewer
from .traffic import poses

FRAME_TIME = 1.0 / 60.0
# Set-up renders a frame at SWEEP poses spread over the list (every
# kernel built, buffers of every visible-set size allocated), clears the
# history and renders the LEAD_IN poses before the list's first.
SWEEP = 8
LEAD_IN = 3
JUDGED_DRAWN = 2
JUDGED_WITHIN = 120
# The raster counters of a frame that say the viewer dropped geometry.
DROP_COUNTERS = ("visible_overflow", "huge_overflow", "clamped_entries")
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ConfigError(ValueError):
    """A configuration the harness cannot judge as it is written."""


def _static_shadow(app):
    """The cached static sun map (B1 at set-up)."""
    cache = app._static_shadow_cache
    return cache[1] if cache else None


def _cluster_atlas(app):
    """The clustered lights' depth atlas (B1 at set-up), (slices, S, S):
    the viewer's flat atlas holds each texel's 2x2 footprint."""
    atlas = app._cluster_shadow
    if not atlas:
        return None
    size = atlas["size"]
    return atlas["atlas_flat"][:, 0].reshape(-1, size, size)


# The port-side sources of a judged map ("judged_maps" of a
# configuration): "setup:<name>" reads the viewer once the window has
# closed; "frame:<pool resource>" keeps that plane of the graph's pool
# from each judged frame.
SETUP_SOURCES = {"static_shadow": _static_shadow,
                 "cluster_atlas": _cluster_atlas}


def judged_maps(config: dict) -> tuple:
    """-> ({limit: setup source}, {limit: pool resource}) of the
    configuration's "judged_maps"; ConfigError for a source the harness
    does not know or a map without a limit."""
    maps = config.get("judged_maps")
    if not isinstance(maps, dict):
        raise ConfigError('the configuration has no "judged_maps"')
    setup, frame = {}, {}
    for limit, source in maps.items():
        kind, _, name = str(source).partition(":")
        if kind == "setup" and name in SETUP_SOURCES:
            setup[limit] = name
        elif kind == "frame" and name:
            frame[limit] = name
        else:
            raise ConfigError(f"judged map {limit!r}: unknown source "
                              f"{source!r} (setup:{'|'.join(SETUP_SOURCES)}"
                              " or frame:<pool resource>)")
        if limit not in config.get("limits", {}):
            raise ConfigError(f"judged map {limit!r} has no limit")
    return setup, frame


def _same(a, b) -> bool:
    return type(a) is type(b) and a == b


def unmodelled_knobs(cls, viewer: dict) -> list:
    """The (knob, value) pairs of the viewer's config that the reference
    class does not model (its KNOBS)."""
    return [(k, v) for k, v in viewer.items()
            if k not in cls.KNOBS or (cls.KNOBS[k] is not None and not any(
                _same(v, a) for a in cls.KNOBS[k]))]


def reference_for(config: dict) -> type:
    """The reference class the configuration names ("reference":
    "<module>:<class>", a module under benchmark/), once it is shown to
    model every viewer knob the configuration sets and every judged map
    has a source and a limit.  Constructs nothing; ConfigError names what
    it refuses."""
    spec = config.get("reference")
    mod_name, _, cls_name = str(spec).partition(":")
    if not isinstance(spec, str) or not mod_name or not cls_name:
        raise ConfigError(f'"reference" must be "<module>:<class>", '
                          f"not {spec!r}")
    try:
        mod = importlib.import_module(mod_name)
    except ModuleNotFoundError as e:
        if e.name is None or (e.name != mod_name
                              and not mod_name.startswith(e.name + ".")):
            raise
        raise ConfigError(f"reference {spec}: no module {mod_name}") from e
    path = os.path.abspath(getattr(mod, "__file__", None) or "")
    if not path.startswith(BENCH + os.sep):
        raise ConfigError(f"reference {spec}: {path or mod_name} is not "
                          "under benchmark/")
    cls = getattr(mod, cls_name, None)
    if not isinstance(cls, type):
        raise ConfigError(f"reference {spec}: no class {cls_name}")
    off = unmodelled_knobs(cls, config.get("viewer", {}))
    if off:
        raise ConfigError(f"reference {spec} does not model the viewer "
                          "knob(s) " + ", ".join(f"{k} = {v!r}"
                                                for k, v in off))
    judged_maps(config)
    return cls


def process_age_s(fallback_t0: float) -> float:
    """Seconds since this process started (/proc's start time), or since
    fallback_t0 on the host clock where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - fallback_t0


def host_counters() -> dict:
    """The process's and this thread's CPU seconds: a frame loop that ran
    slower on the CPU tells itself from one that waited."""
    return {"process_cpu_s": time.process_time(),
            "thread_cpu_s": time.thread_time()}


def judged_frames(seed: int) -> list:
    """Frame numbers of the window judged besides its last: 0 and
    JUDGED_DRAWN distinct ones drawn from the seed in [1, JUDGED_WITHIN)."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 1])
    more = rng.choice(np.arange(1, JUDGED_WITHIN), size=JUDGED_DRAWN,
                      replace=False)
    return [0] + sorted(int(v) for v in more)


class FrameLoop:
    """The viewer driven as the headless runner drives it, with the
    harness's host spans around each call."""

    def __init__(self, app, pos, rot):
        self.app, self.pos, self.rot = app, pos, rot
        self.elapsed = 0.0
        self.pool = None
        run_pass = app.graph.run_pass

        def capture(pname, pool, history, params, bands=None):
            self.pool = pool
            return run_pass(pname, pool, history, params, bands)
        app.graph.run_pass = capture

    def set_pose(self, i: int) -> None:
        cam = self.app.camera
        cam.position = self.pos[i].copy()
        cam.rotation = self.rot[i].copy()

    def frame(self, i: int):
        """Frame at pose i -> (t_call, render_s, ring_s, keep): keep holds
        the graph's pool of the frame, its raster counters and the
        thread's CPU seconds inside render_frame (cpu_s)."""
        app = self.app
        self.set_pose(i)
        self.elapsed += FRAME_TIME
        c_call = time.thread_time()
        t_call = time.perf_counter()
        with torch.profiler.record_function("bench:render_frame"):
            out = app.render_frame(FRAME_TIME, self.elapsed)
        t_ret = time.perf_counter()
        cpu_s = time.thread_time() - c_call
        keep = {"pool": self.pool, "raster_stats": dict(app.raster_stats),
                "pose": i, "cpu_s": cpu_s}
        app.hub.frame().track(out)
        with torch.profiler.record_function("bench:ring_wait"):
            t0 = time.perf_counter()
            app.hub.next_frame_context()
            t1 = time.perf_counter()
        with torch.profiler.record_function("bench:post_frame"):
            app.post_frame()
        return t_call, t_ret - t_call, t1 - t0, keep

    def close(self) -> None:
        del self.app.graph.run_pass
        self.pool = None


def port_planes(pool: dict) -> dict:
    """The judged planes of a frame out of the graph's pool."""
    out = {"depth": pool["depth-main"], "hdr": pool["hdr"],
           "backbuffer": pool["backbuffer"]}
    if "g-covered" in pool:
        out["covered"] = pool["g-covered"]
        for name in J.GBUFFER_PLANES:
            out[name] = pool[name]
    else:
        out["covered"] = pool["depth-main"] > 0
    return out


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: float | None = None,
             fault=None, log=print) -> dict:
    """-> the run's readings: end-to-end times, host spans, the trace's
    readings (trace=True), the checks and everything the output file
    keeps.  fault(app): an optional change planted in the viewer before
    set-up ends (the tests' broken timed paths)."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    W, H = int(traffic["width"]), int(traffic["height"])
    setup_maps, frame_maps = judged_maps(config)
    viewer_cfg = config["viewer"]
    info = build_scene(config["scene"])
    lens_ = lens(info)
    pos, rot = poses(traffic, seed)
    L = len(pos)
    app = make_viewer(info, viewer_cfg, lens_,
                      config["scene"].get("load") == "gltf", device)
    app.swapchain_updated(W, H)
    loop = FrameLoop(app, pos, rot)
    for k in range(SWEEP):
        loop.frame((k * L) // SWEEP)
    sync()
    app.reset_history()
    lead = [(L - LEAD_IN + j) % L for j in range(LEAD_IN)]
    for i in lead:
        loop.frame(i)
    sync()
    if fault is not None:
        fault(app)
    from granite_tpu_torch.kernels import build as K
    setup_s = process_age_s(t0)

    judged = judged_frames(seed)
    kept: dict = {}
    calls, render_s, ring_s, cpu_s, events = [], [], [], [], []
    launches0 = dict(K.LAUNCHES)
    # What set-up allocated is moved out of the collector's sight, so a
    # full collection inside the window walks only the window's objects.
    gc.collect()
    gc.freeze()
    sync()
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    host0 = host_counters()
    t_start = time.perf_counter()
    n = 0
    while time.perf_counter() - t_start < seconds:
        t_call, r_s, w_s, keep = loop.frame(n % L)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            events.append(time.perf_counter())
        calls.append(t_call - t_start)
        render_s.append(r_s)
        ring_s.append(w_s)
        cpu_s.append(keep["cpu_s"])
        if n in judged:
            kept[n] = keep
        n += 1
    sync()
    t_end = time.perf_counter()
    host1 = host_counters()
    gc.unfreeze()
    kept[n - 1] = keep
    del keep
    launches = {k: v - launches0[k] for k, v in K.LAUNCHES.items()}
    if cuda:
        done_ms = [start.elapsed_time(ev) for ev in events]
    else:
        done_ms = [1e3 * (t - t_start) for t in events]
    res = {"frames": n, "window_s": t_end - t_start, "setup_s": setup_s,
           "done_ms": done_ms, "call_s": calls,
           "render_call_ms": [1e3 * v for v in render_s],
           "ring_wait_ms": [1e3 * v for v in ring_s],
           "render_cpu_ms": [1e3 * v for v in cpu_s],
           "host": {k: host1[k] - host0[k] for k in host1},
           "launches": launches, "poses": {"positions": pos.tolist(),
                                           "rotations": rot.tolist(),
                                           "lead_in": lead},
           "width": W, "height": H}
    log(f"window: {n} frames in {t_end - t_start:.3f} s; set-up "
        f"{setup_s:.3f} s; launches {launches}")

    if trace:
        from .trace import traced
        tf = int(traffic.get("trace_frames", 16))

        def run_frames(k):
            for j in range(k):
                loop.frame((n + j) % L)
        res["trace"] = traced(run_frames, tf, app.graph._order[-1])
        res["trace_poses"] = [(n + j) % L for j in range(tf)]
    res["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) \
        if cuda else 0

    # The viewer's state is freed before the reference runs; the judged
    # planes and maps stay.
    res["setup_maps"] = {limit: SETUP_SOURCES[name](app)
                         for limit, name in setup_maps.items()}
    judged_planes = {}
    for fno, keep in kept.items():
        judged_planes[fno] = {
            "pose": keep["pose"], "planes": port_planes(keep["pool"]),
            "maps": {limit: keep["pool"].get(name)
                     for limit, name in frame_maps.items()},
            "counters": {k: {c: int(v) for c, v in s.items()}
                         for k, s in keep["raster_stats"].items()}}
    loop.close()
    del kept, loop, app
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    res["judged"] = judged_planes
    res["info"], res["lens"] = info, lens_
    return res


def compare(res: dict, config: dict, device: str = "cuda",
            control: bool = False, log=print, refs=None) -> dict:
    """The reference's readings against the run's judged planes and maps
    -> the numbers (each the worst over the judged frames) and per-frame
    detail.  The reference is the class the configuration names.
    control=True puts the reference at bfloat16 stage outputs in the
    viewer's place (its numbers are the control's readings).  refs: a
    dict that keeps the references ("ref", "ctl") for another run of the
    same configuration and size.  A judged map that either side lacks
    gives no number, so the run is not correct."""
    cls = reference_for(config)
    setup_maps, frame_maps = judged_maps(config)
    t = time.perf_counter()
    W, H = res["width"], res["height"]
    pos = np.asarray(res["poses"]["positions"], np.float32)
    rot = np.asarray(res["poses"]["rotations"], np.float32)
    if refs is None:
        refs = {}
    if "ref" not in refs:
        refs["ref"] = cls(res["info"], config["viewer"], W, H, res["lens"],
                          device)
    if control and "ctl" not in refs:
        refs["ctl"] = cls(res["info"], config["viewer"], W, H, res["lens"],
                          device, control=True)
    ref, ctl = refs["ref"], refs.get("ctl")
    for r in (ref, ctl):
        if r is not None:
            r.history = r.initial_history()
    nums: dict = {}
    detail: dict = {}

    def worst(name, value):
        nums[name] = max(nums.get(name, 0.0), value)

    def judge_map(limit, port_map, ref_map, out):
        if port_map is None or ref_map is None:
            log(f"judged map {limit}: none on the "
                f"{'viewer' if port_map is None else 'reference'}'s side")
        else:
            out[limit] = J.compare_depth_map(port_map, ref_map)

    for limit in setup_maps:
        judge_map(limit, getattr(ctl, limit, None) if control
                  else res["setup_maps"][limit], getattr(ref, limit, None),
                  nums)
    for i in res["poses"]["lead_in"]:
        ref.post(ref.surface(pos[i], rot[i])["hdr"])
        if control:
            ctl.post(ctl.surface(pos[i], rot[i])["hdr"])
    for fno in sorted(res["judged"]):
        jf = res["judged"][fno]
        i = jf["pose"]
        r = ref.surface(pos[i], rot[i])
        if control:
            p = ctl.surface(pos[i], rot[i])
        else:
            p = jf["planes"]
        if not ref.deferred:
            p["covered"] = p["depth"] > 0
        d = J.compare_surface(p, r)
        for limit in frame_maps:
            judge_map(limit, p.get(limit) if control else jf["maps"][limit],
                      r.get(limit), d)
        if fno == 0:
            bb_ref = ref.post(r["hdr"])
            bb = ctl.post(p["hdr"]) if control else p["backbuffer"]
            d["backbuffer"] = J.compare_backbuffer(bb, bb_ref)
        for k, v in d.items():
            worst(k, v)
        dropped = {k: {c: v for c, v in s.items() if c in DROP_COUNTERS}
                   for k, s in jf["counters"].items()}
        detail[fno] = {"pose": i, "numbers": d, "counters": dropped,
                       "errors": J.errors(p, r),
                       "all_counters": jf["counters"]}
        if d["geometry"] > 0:
            geo = J.geometry_mask(p, r)
            ys, xs = torch.nonzero(geo, as_tuple=True)
            detail[fno]["geometry_pixels"] = int(geo.sum())
            detail[fno]["geometry_bbox"] = [int(xs.min()), int(ys.min()),
                                            int(xs.max()), int(ys.max())]
    log(f"reference: {len(res['judged'])} judged frames in "
        f"{time.perf_counter() - t:.3f} s")
    return {"numbers": nums, "detail": detail, "ref": ref}
