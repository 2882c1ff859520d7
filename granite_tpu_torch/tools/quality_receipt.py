"""Quality receipt for the bench's half-res shading trades (port of
tools/quality_receipt.py).

The bench config opts into two quality/perf trades the reference does
not take (it shades shadow terms per-pixel:
assets/shaders/lights/directional.frag, lights/clusterer.h):
  * shadowTermHalfRes          (sun PCF term at half res + bilinear up)
  * clusteredLightsShadowsHalfRes (clustered shadow term at half res)

This tool renders the SAME frame of the bench scene under the bench
config and under the per-pixel config on --device (default cuda), writes
both PNGs, and prints the luma PSNR between them
(tools/image_compare.cpp:108-250 metric), the largest channel difference
and the share of pixels that changed, as one JSON line.

  python -m granite_tpu_torch.tools.quality_receipt [--width 1920
      --height 1080] [--frames 4] [--out dir] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import types

import numpy as np

# The bench config without its two trades.
BASE = {"renderer": "deferred", "hdrBloom": True,
        "shadowMapResolution": 2048, "rasterMaxVisible": 163840}
BENCH_TRADES = {"shadowTermHalfRes": True,
                "clusteredLightsShadowsHalfRes": True}
PER_PIXEL = {"shadowTermHalfRes": False,
             "clusteredLightsShadowsHalfRes": False}


def render(cfg: dict, width: int, height: int, frames: int,
           device) -> np.ndarray:
    """The bench scene under cfg: `frames` frames from the same camera
    (exposure history converging) -> the last (H, W, 4) uint8 frame."""
    from ..app.scene_viewer import SceneViewerApplication
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        app = SceneViewerApplication(types.SimpleNamespace(
            scene=None, config=path, camera_index=-1, bench_scene=True),
            device=device)
    app.swapchain_updated(width, height)
    out = None
    for _ in range(frames):
        out = app.render_frame(1 / 60, 0.0)
    return out.cpu().numpy()


def luma_psnr(a, b) -> float:
    la = a[..., :3].astype(np.float64) @ [0.2126, 0.7152, 0.0722]
    lb = b[..., :3].astype(np.float64) @ [0.2126, 0.7152, 0.0722]
    mse = float(np.mean((la - lb) ** 2))
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "quality_receipt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from ..utils.image_io import save_png

    imgs = {}
    for name, trades in (("bench_halfres", BENCH_TRADES),
                         ("per_pixel", PER_PIXEL)):
        cfg = dict(BASE, **trades)
        imgs[name] = render(cfg, args.width, args.height, args.frames,
                            args.device)
        png = os.path.join(args.out, f"{name}.png")
        save_png(png, imgs[name])
        print(f"wrote {png}")

    psnr = luma_psnr(imgs["bench_halfres"], imgs["per_pixel"])
    diff = np.abs(imgs["bench_halfres"][..., :3].astype(int)
                  - imgs["per_pixel"][..., :3].astype(int))
    print(json.dumps({"lumaPSNRdB": round(psnr, 2),
                      "maxAbsDiff": int(diff.max()),
                      "pctPixelsChanged":
                          round(float((diff.max(-1) > 0).mean()) * 100, 2),
                      "width": args.width, "height": args.height}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
