"""Headless GTPX texture viewer (port of tools/texture_viewer.py;
reference: tools/texture_viewer.cpp, which decodes any supported texture
and displays it; here a level is decoded to PNG or NPY for inspection).

  python -m granite_tpu_torch.tools.texture_viewer file.gtpx \
      --output out.png [--level 0]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .gtx_cat import level_size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("--output", required=True, help=".png or .npy")
    ap.add_argument("--level", type=int, default=0)
    args = ap.parse_args(argv)

    from ..native.texture import decode_bc6h, decode_blocks, gtpx_load

    fmt, w, h, levels, flags, payload = gtpx_load(args.input)
    if not (0 <= args.level < levels):
        print(f"level {args.level} out of range (0..{levels - 1})")
        return 1
    off = 0
    lw, lh = w, h
    for _ in range(args.level):
        off += level_size(fmt, lw, lh)
        lw = max(lw // 2, 1)
        lh = max(lh // 2, 1)
    data = np.frombuffer(payload, np.uint8,
                         count=level_size(fmt, lw, lh), offset=off)
    if fmt == "rgba8":
        img = data.reshape(lh, lw, 4)
    elif fmt.startswith("bc6h"):
        rgb = decode_bc6h(data, lw, lh, signed=fmt.endswith("_s"))
        if args.output.endswith(".npy"):
            np.save(args.output, rgb)
            print(f"wrote {args.output} ({lw}x{lh} f32 HDR)")
            return 0
        # simple reinhard for PNG preview
        t = rgb / (1.0 + rgb)
        img = np.concatenate([(t * 255).astype(np.uint8),
                              np.full((lh, lw, 1), 255, np.uint8)], -1)
    else:
        img = decode_blocks(fmt, data, lw, lh)
    if args.output.endswith(".npy"):
        np.save(args.output, img)
    else:
        from ..utils.image_io import save_png
        save_png(args.output, img)
    print(f"wrote {args.output} ({fmt} level {args.level}: {lw}x{lh})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
