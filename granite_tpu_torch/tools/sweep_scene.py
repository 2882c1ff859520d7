"""Perf sweep harness (port of tools/sweep_scene.py; reference:
tools/sweep_scene.py:17-42).

Runs the headless viewer once per config file for N iterations, each in
its own process, reads the stat JSON's averageFrameTimeUs, and reports
mean/stdev per config.  A viewer that exits non-zero raises.

  python -m granite_tpu_torch.tools.sweep_scene --scene s.gltf \
      --configs a.json b.json --iterations 3 --width 1280 --height 720 \
      --frames 32 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

from ._viewer_process import run_viewer


def run_once(args, config) -> float:
    with tempfile.TemporaryDirectory() as tmp:
        stat = os.path.join(tmp, "stat.json")
        cmd = ["--width", str(args.width), "--height", str(args.height),
               "--frames", str(args.frames), "--time-step", "0.0166",
               "--stat", stat, "--device", args.device]
        if args.scene:
            cmd += ["--scene", args.scene]
        if config:
            cmd += ["--config", config]
        run_viewer(cmd)
        with open(stat) as f:
            return json.load(f)["averageFrameTimeUs"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", type=str, default=None)
    ap.add_argument("--configs", nargs="*", default=[None])
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="the viewer's torch device (cuda or cpu)")
    args = ap.parse_args(argv)

    results = {}
    for config in args.configs:
        name = config or "<default>"
        times = [run_once(args, config) for _ in range(args.iterations)]
        results[name] = {
            "averageFrameTimeUs": statistics.mean(times),
            "stdev": statistics.stdev(times) if len(times) > 1 else 0.0,
            "iterations": times,
        }
        print(f"{name}: {statistics.mean(times):.1f} us "
              f"(+/- {results[name]['stdev']:.1f})")
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
