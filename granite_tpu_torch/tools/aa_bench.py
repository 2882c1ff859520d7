"""AA quality/perf sweep (port of tools/aa_bench.py; reference:
tools/aa_bench.cpp + tools/bench_aa.py).

Renders the same scene once per AA mode, each in its own viewer process
through the chained loop (--chain), reports frame time from the stat
JSON and PSNR of each mode against the first mode (default: none).  A
viewer that exits non-zero raises.

  python -m granite_tpu_torch.tools.aa_bench --modes none fxaa taa smaa \
      --frames 16 --width 640 --height 360 [--scene s.gltf] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from ..utils.image_compare import psnr_channels
from ..utils.image_io import load_image
from ._viewer_process import run_viewer


def run_mode(args, mode: str, outdir: str):
    cfg = {"postAA": mode, "shadowMapResolution": 256}
    if mode == "taaFSR2":
        # FSR2 renders at reduced resolution and upscales to display
        # (temporal.hpp:91 scaling_factor contract).
        cfg["resolutionScale"] = args.fsr2_scale
    cfg_path = os.path.join(outdir, f"cfg_{mode}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    stat = os.path.join(outdir, f"stat_{mode}.json")
    png = os.path.join(outdir, f"{mode}.png")
    cmd = ["--width", str(args.width), "--height", str(args.height),
           "--frames", str(args.frames), "--time-step", "0.0166",
           "--chain", "--config", cfg_path, "--stat", stat,
           "--png-path", png, "--device", args.device]
    if args.scene:
        cmd += ["--scene", args.scene]
    run_viewer(cmd)
    with open(stat) as f:
        return json.load(f)["averageFrameTimeUs"], png


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", nargs="+",
                    default=["none", "fxaa", "taa", "smaa", "smaaT2X",
                             "taaFSR2"])
    ap.add_argument("--fsr2-scale", type=float, default=0.67)
    ap.add_argument("--scene", default=None)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the viewer's torch device (cuda or cpu)")
    args = ap.parse_args(argv)

    outdir = args.outdir or tempfile.mkdtemp(prefix="aa_bench_")
    os.makedirs(outdir, exist_ok=True)
    results = {}
    ref_png = None
    for mode in args.modes:
        us, png = run_mode(args, mode, outdir)
        entry = {"averageFrameTimeUs": us}
        if ref_png is None:
            ref_png = png
        else:
            entry.update(psnr_channels(load_image(png),
                                       load_image(ref_png)))
        results[mode] = entry
        print(f"{mode:12s} {us:10.1f} us"
              + (f"  luma-psnr-vs-{args.modes[0]} "
                 f"{entry.get('psnrLuma', 0):.2f} dB"
                 if mode != args.modes[0] else ""))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
