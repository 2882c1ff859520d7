"""Image comparison gate (port of tools/image_compare.py; reference:
tools/image_compare.cpp:108-250).

Computes per-channel + luma PSNR and RMSE between two images, gates on a
threshold, and optionally writes an amplified diff image.

  python -m granite_tpu_torch.tools.image_compare --inputs a.png b.png \
      --threshold 40 --diff diff.png
Exit code 0 when all PSNRs >= threshold, 1 otherwise, 2 on a size
mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.image_compare import diff_image, psnr_channels
from ..utils.image_io import load_image, save_png


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", nargs=2, required=True)
    ap.add_argument("--threshold", type=float, default=0.0,
                    help="minimum acceptable PSNR (dB) per channel")
    ap.add_argument("--diff", type=str, default=None,
                    help="write amplified (x16) diff image here")
    ap.add_argument("--amplify", type=float, default=16.0)
    args = ap.parse_args(argv)

    a = load_image(args.inputs[0])
    b = load_image(args.inputs[1])
    if a.shape[:2] != b.shape[:2]:
        print(f"size mismatch: {a.shape} vs {b.shape}", file=sys.stderr)
        return 2
    m = psnr_channels(a, b)
    print(json.dumps(m, indent=2))
    if args.diff:
        save_png(args.diff, diff_image(a, b, args.amplify))
    worst = min(m["psnrR"], m["psnrG"], m["psnrB"], m["psnrLuma"])
    if worst < args.threshold:
        print(f"FAIL: worst PSNR {worst:.2f} < {args.threshold}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
