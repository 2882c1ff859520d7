"""Headless runner (port of granite_tpu/app/headless.py, the flags the
slice needs): --frames --width --height --time-step --warmup-frames
--png-path --stat, plus --device (default cuda; raises without CUDA).

Frames run back to back with no host readback until the end; the stat
JSON reports averageFrameTimeUs measured on the host clock around work
that ends in a device synchronize, and names the device it ran on.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from ..utils.image_io import save_png
from ..utils.logging import LOGI


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
    parser.add_argument("--stat", type=str, default=None,
                        help="write stat JSON to this path")
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


def run_headless(app, args: argparse.Namespace) -> int:
    frames = max(args.frames, 1)
    app.swapchain_updated(args.width, args.height)
    step = args.time_step or (1.0 / 60.0)
    for i in range(max(args.warmup_frames, 0)):
        app.render_frame(step, i * step)
    _sync(app.device)
    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if app.device.type == "cuda" else []))
    with prof:
        t0 = time.perf_counter()
        out = None
        for i in range(frames):
            out = app.render_frame(step, i * step)
        _sync(app.device)
        avg_us = (time.perf_counter() - t0) * 1e6 / frames
    if args.profile:
        sort = "device_time_total" if app.device.type == "cuda" \
            else "cpu_time_total"
        with open(args.profile, "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=80))
        LOGI("Wrote %s", args.profile)
    host = out.cpu().numpy()
    if args.png_path:
        save_png(args.png_path, np.asarray(host))
        LOGI("Wrote %s", args.png_path)
    device_name = (torch.cuda.get_device_name(app.device)
                   if app.device.type == "cuda" else "cpu")
    if args.stat:
        with open(args.stat, "w") as f:
            json.dump({"averageFrameTimeUs": avg_us, "frames": frames,
                       "device": device_name}, f)
    LOGI("averageFrameTimeUs=%.1f over %d frames on %s", avg_us, frames,
         device_name)
    return 0


def headless_main(app_factory, argv=None) -> int:
    parser = argparse.ArgumentParser()
    add_headless_cli(parser)
    app_factory.add_cli(parser)
    args = parser.parse_args(argv)
    app = app_factory(args, device=args.device)
    return run_headless(app, args)
