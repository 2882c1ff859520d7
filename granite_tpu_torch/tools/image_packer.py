"""Image -> GTPX packer with mip generation and BCn compression (port of
tools/image_packer.py; reference: tools/image_packer.cpp, which packs
source images into a .gtx with full mip chains and optional
compression).

  python -m granite_tpu_torch.tools.image_packer in.png --output out.gtpx
      [--format rgba8|bc1|bc3|bc4|bc5|bc7|bc6h] [--mips] [--srgb]

bc6h takes float HDR input (a .npy float array, kept linear); the
other formats take 8-bit LDR (PNG or uint8 .npy).  A PNG given for bc6h
is taken as sRGB and linearized with the exact sRGB EOTF (ops/srgb.
srgb_to_linear, IEC 61966-2-1), where the JAX tool raises the bytes to
the power 2.2: that is off the curve by up to 0.0085 in linear value
(at byte 191), and near black, where the curve is linear, it gives
almost nothing (byte 1: 5.1e-6 against 3.0e-4).  The mip chain of a
non-square image is fixed too (see _half).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _half(cur):
    """One box-filtered level down: 2x2 blocks, 1x2 or 2x1 once an axis
    is 1 texel wide.  The JAX tool pairs rows and columns alike, which
    for a non-square image (29x37: 3x4 -> 1x2 -> 1x1) reshapes the 1x2
    level into garbage channels; square and power-of-two chains take
    the same blocks in both."""
    fy = 2 if cur.shape[0] > 1 else 1
    fx = 2 if cur.shape[1] > 1 else 1
    h, w = cur.shape[0] // fy, cur.shape[1] // fx
    return cur[:h * fy, :w * fx].reshape(h, fy, w, fx, -1).mean((1, 3))


def box_mips(img):
    """8-bit mips: each level the box average of the previous level's
    unrounded values, rounded and clamped."""
    levels = [img]
    cur = img.astype(np.float32)
    while max(cur.shape[0], cur.shape[1]) > 1:
        cur = _half(cur)
        levels.append(np.clip(cur + 0.5, 0, 255).astype(img.dtype))
    return levels


def float_mips(img):
    """Float mips: plain box average, no rounding or clamp."""
    levels = [img]
    cur = img
    while max(cur.shape[0], cur.shape[1]) > 1:
        cur = _half(cur).astype(np.float32)
        levels.append(cur)
    return levels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("--output", required=True)
    ap.add_argument("--format", default="bc1",
                    choices=["rgba8", "bc1", "bc3", "bc4", "bc5",
                             "bc7", "bc6h"])
    ap.add_argument("--mips", action="store_true")
    ap.add_argument("--srgb", action="store_true",
                    help="tag the container sRGB (flag bit 0)")
    args = ap.parse_args(argv)

    from ..native.texture import (
        encode_bc1, encode_bc3, encode_bc4, encode_bc5, encode_bc6h,
        encode_bc7, gtpx_save,
    )
    from ..ops.srgb import srgb_to_linear
    from ..utils.image_io import load_image

    hdr = args.format == "bc6h"
    if args.input.endswith(".npy"):
        img = np.load(args.input)
        if hdr:
            img = img.astype(np.float32)
        elif img.dtype != np.uint8:
            img = np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8)
    else:
        img = load_image(args.input)
        if hdr:   # PNG fallback: sRGB bytes -> linear HDR
            img = srgb_to_linear(torch.from_numpy(
                img.astype(np.float32) / 255.0)).numpy()
    if img.ndim == 2:
        img = img[..., None]
    if hdr:
        if img.shape[-1] < 3:
            img = np.concatenate(
                [img] + [img[..., :1]] * (3 - img.shape[-1]), axis=-1)
        img = np.ascontiguousarray(img[..., :3], np.float32)
    elif img.shape[-1] < 4:
        pad = np.full(img.shape[:2] + (4 - img.shape[-1],), 255,
                      np.uint8)
        pad[..., :max(3 - img.shape[-1], 0)] = 0
        img = np.concatenate([img, pad], axis=-1)

    if args.mips:
        levels = float_mips(img) if hdr else box_mips(img)
    else:
        levels = [img]
    enc = {"rgba8": lambda x: x.tobytes(), "bc1": encode_bc1,
           "bc3": encode_bc3, "bc4": encode_bc4, "bc5": encode_bc5,
           "bc7": encode_bc7, "bc6h": encode_bc6h}
    payload = b""
    for lv in levels:
        out = enc[args.format](np.ascontiguousarray(lv))
        payload += out if isinstance(out, bytes) else bytes(out)
    gtpx_save(args.output, payload, args.format, img.shape[1],
              img.shape[0], levels=len(levels),
              flags=1 if args.srgb else 0)
    print(f"wrote {args.output}: {args.format} {img.shape[1]}x"
          f"{img.shape[0]} levels={len(levels)} "
          f"({img.nbytes} -> {len(payload)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
