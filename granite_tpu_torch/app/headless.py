"""Headless runner (port of granite_tpu/app/headless.py): --frames --width
--height --time-step --warmup-frames --png-path --png-reference-path
--stat --video-path --chain --capture-probe, plus --profile and --device
(default cuda; raises without CUDA).

The frames go through the same calls as the JAX runner's: with
--capture-probe the environment probe first, then the warm-up frames at
elapsed time 0, then the timed frames at FrameTimer's frame and elapsed
times ((i + 1) x step under --time-step, the wall clock without it), or
with --chain one render_frames_chained(step, 0, frames) to warm up and
one render_frames_chained(step, step, frames) timed.  The timed frames
run back to back with no host readback until the end; after each
non-chained one the runner tracks its output in the app's frame ring
(`app.hub.frame().track(out)`), moves the ring on
(`app.hub.next_frame_context()`, which waits for the frame
GRANITE_VULKAN_SWAPCHAIN_IMAGES back, so the host queues at most that
many frames) and calls app.post_frame() (texture streaming's latch, file
notifications, hot reload), as the JAX runner does.  The last call is
app.teardown() (not after a refused reference image), as in JAX.  The
chained path calls no post_frame in either runner, so a streamed scene
under --chain keeps its fallback textures.  The stat JSON keeps the JAX
engine's schema (core/stats.StatSink): averageFrameTimeUs on the host
clock around work that ends in a device synchronize; gpu,
the card's name or "cpu"; performanceCounters compileTimeMs (warm-up
frames, the kernel build included), wallTimePerFrameUs and, with
--png-reference-path, the PSNR counters of utils/image_compare;
passTimesUs, each `pass:<name>` range's device time a frame (CPU time on
the CPU) when --profile traces the frames, else {}.  Here the port
parts from the JAX runner, which merges the hub's host-clock intervals
(GRANITE_DEBUG_GRAPH's per-pass ms) into passTimesUs: they stay in
`app.hub.stats` and the app's breadcrumbs.
A reference image of another size exits 1; --chain with --video-path is
refused (exit 2).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

from ..core.stats import StatSink
from ..utils.image_compare import psnr_channels
from ..utils.image_io import load_image, save_png
from ..utils.logging import LOGE, LOGI
from ..utils.timer import FrameTimer
from .video_sink import VideoSink

# Face size and equirect height of --capture-probe (the JAX runner's).
PROBE_FACE_SIZE, PROBE_HEIGHT = 128, 64


def add_headless_cli(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--frames", type=int, default=0,
                        help="render N frames then exit (0 = 1 frame)")
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--time-step", type=float, default=None,
                        dest="time_step",
                        help="fixed frame time step in seconds")
    parser.add_argument("--warmup-frames", type=int, default=2,
                        dest="warmup_frames")
    parser.add_argument("--png-path", type=str, default=None,
                        dest="png_path")
    parser.add_argument("--png-reference-path", type=str, default=None,
                        dest="png_reference_path",
                        help="compare the last frame with this image; "
                             "PSNR counters go into the stat JSON")
    parser.add_argument("--stat", type=str, default=None,
                        help="write stat JSON to this path")
    parser.add_argument("--video-path", type=str, default=None,
                        dest="video_path",
                        help="encode every timed frame (ffmpeg or a PNG "
                             "sequence)")
    parser.add_argument("--chain", action="store_true",
                        help="time the frames through "
                             "render_frames_chained; refused with "
                             "--video-path")
    parser.add_argument("--capture-probe", type=str, default=None,
                        dest="capture_probe",
                        help="render a 6-face environment probe and write "
                             "an equirect PNG and .npy to this path")
    parser.add_argument("--profile", type=str, default=None,
                        help="trace the timed frames with torch.profiler "
                             "and write the per-pass / per-kernel table "
                             "to this path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda or cpu); cuda raises "
                             "when no card is present")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pass_times_us(prof, device: torch.device, frames: int) -> dict:
    """Per-frame µs of each `pass:<name>` range, from its host-side
    events: the device time of the kernels launched inside it on the
    card, its CPU time on the CPU.  (key_averages() would merge in the
    range's device-side annotation, whose time is the span from its first
    kernel to its last, idle gaps included.)"""
    from torch.autograd import DeviceType
    out: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name.startswith("pass:"):
            total = ev.device_time_total if device.type == "cuda" \
                else ev.cpu_time_total
            out[ev.name] = out.get(ev.name, 0.0) + total / frames
    return out


def run_headless(app, args: argparse.Namespace) -> int:
    video_path = getattr(args, "video_path", None)
    use_chain = bool(getattr(args, "chain", False))
    if use_chain and video_path:
        LOGE("--chain renders the frames with no readback between them, so "
             "it cannot encode per-frame video (--video-path)")
        return 2
    frames = max(args.frames, 1)
    app.swapchain_updated(args.width, args.height)
    device_name = app.hub.backend.gpu_name()
    stats = StatSink(device_name)
    timer = FrameTimer()
    if getattr(args, "capture_probe", None):
        app.capture_environment_probe(args.capture_probe,
                                      face_size=PROBE_FACE_SIZE,
                                      equirect_height=PROBE_HEIGHT)
    step = args.time_step or (1.0 / 60.0)
    t_compile0 = time.perf_counter()
    if use_chain:
        app.render_frames_chained(step, 0.0, frames)
    else:
        for _ in range(max(args.warmup_frames, 0)):
            app.render_frame(step, 0.0)
    _sync(app.device)
    stats.counters["compileTimeMs"] = \
        (time.perf_counter() - t_compile0) * 1e3
    sink = VideoSink(video_path, args.width, args.height, fps=1.0 / step) \
        if video_path else None
    prof = contextlib.nullcontext()
    if getattr(args, "profile", None):
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if app.device.type == "cuda" else []))
    with prof:
        t0 = time.perf_counter()
        if use_chain:
            out = app.render_frames_chained(step, step, frames)
        else:
            for _ in range(frames):
                ft = timer.frame(fixed_step=args.time_step)
                out = app.render_frame(ft, timer.get_elapsed())
                app.hub.frame().track(out)
                app.hub.next_frame_context()
                app.post_frame()
                if sink is not None:
                    sink.push_frame(out.cpu().numpy())
        _sync(app.device)
        total_s = time.perf_counter() - t0
    if sink is not None:
        sink.close()
    for _ in range(frames):
        stats.add_frame(total_s / frames)
    stats.counters["wallTimePerFrameUs"] = 1e6 * total_s / frames
    if getattr(args, "profile", None):
        sort = "device_time_total" if app.device.type == "cuda" \
            else "cpu_time_total"
        with open(args.profile, "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=80))
        LOGI("Wrote %s", args.profile)
        for tag, us in _pass_times_us(prof, app.device, frames).items():
            stats.intervals.accumulate(tag, us * 1e-6)
    host = out.cpu().numpy()
    if args.png_path:
        save_png(args.png_path, host)
        LOGI("Wrote %s", args.png_path)
    ref_path = getattr(args, "png_reference_path", None)
    if ref_path:
        ref = load_image(ref_path)
        if ref.shape[:2] != host.shape[:2]:
            LOGE("reference size mismatch: %s vs %s", ref.shape, host.shape)
            return 1
        psnr = psnr_channels(host, ref)
        LOGI("PSNR vs reference: %s", psnr)
        stats.counters.update(psnr)
    if args.stat:
        stats.write(args.stat)
        LOGI("Wrote %s", args.stat)
    LOGI("averageFrameTimeUs=%.1f over %d frames on %s",
         stats.average_frame_time_us(), frames, device_name)
    app.teardown()
    return 0


def headless_main(app_factory, argv=None) -> int:
    parser = argparse.ArgumentParser()
    add_headless_cli(parser)
    app_factory.add_cli(parser)
    args = parser.parse_args(argv)
    app = app_factory(args, device=args.device)
    return run_headless(app, args)
