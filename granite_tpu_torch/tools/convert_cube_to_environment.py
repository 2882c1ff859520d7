"""Cubemap -> prefiltered environment baker (port of
tools/convert_cube_to_environment.py; reference:
tools/convert_cube_to_environment.cpp, the same convolution as the
equirect variant but sourced from 6 cube faces).

Resamples the cube to an equirect (the engine's canonical env layout)
then bakes it as the equirect convolver does (GGX reflection chain on
--device + SH irradiance -> one GENV1 .npz).

  python -m granite_tpu_torch.tools.convert_cube_to_environment +x.png
      -x.png +y.png -y.png +z.png -z.png --output env.genv.npz
      [--size 64] [--equirect-height 128] [--samples 64] [--scale 1.0]
      [--device cuda]

Face orientation follows the Vulkan cube convention the reference's
cube sampler uses (+X,-X,+Y,-Y,+Z,-Z, faces viewed from the center).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils.image_io import load_image
from .convert_equirect_to_environment import bake


def _load(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)[..., :3]
    return np.asarray(load_image(path, srgb_to_linear=True),
                      np.float32)[..., :3]


def cube_sample_dirs(height: int) -> np.ndarray:
    """(H, 2H, 3) unit directions for the engine's equirect mapping
    (u = azimuth from +X toward +Z, v = polar from +Y, as
    ops/fastmath.equirect_uv)."""
    h = height
    w = 2 * h
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi                       # from +Y
    phi = u * 2.0 * np.pi                   # from +X toward +Z
    st = np.sin(theta)[:, None]
    y = np.cos(theta)[:, None] * np.ones((1, w))
    x = st * np.cos(phi)[None, :]
    z = st * np.sin(phi)[None, :]
    return np.stack([x, y, z], axis=-1)


def sample_cube(faces: list, dirs: np.ndarray) -> np.ndarray:
    """Bilinear cube fetch per direction (Vulkan face/uv mapping)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    # face select: largest axis
    face = np.where(
        (ax >= ay) & (ax >= az), np.where(x >= 0, 0, 1),
        np.where(ay >= az, np.where(y >= 0, 2, 3),
                 np.where(z >= 0, 4, 5)))
    ma = np.maximum(np.maximum(ax, ay), az)
    # Vulkan cube face UV (sc, tc) per face (spec table 16.10)
    sc = np.select(
        [face == 0, face == 1, face == 2, face == 3, face == 4],
        [-z, z, x, x, x], default=-x)
    tc = np.select(
        [face == 0, face == 1, face == 2, face == 3, face == 4],
        [-y, -y, z, -z, -y], default=-y)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    out = np.zeros(dirs.shape[:-1] + (3,), np.float32)
    for f in range(6):
        img = faces[f]
        fh, fw = img.shape[:2]
        m = face == f
        xu = np.clip(u[m] * fw - 0.5, 0, fw - 1)
        yv = np.clip(v[m] * fh - 0.5, 0, fh - 1)
        x0 = np.floor(xu).astype(int)
        y0 = np.floor(yv).astype(int)
        x1 = np.minimum(x0 + 1, fw - 1)
        y1 = np.minimum(y0 + 1, fh - 1)
        fx = (xu - x0)[..., None]
        fy = (yv - y0)[..., None]
        top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
        bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
        out[m] = top * (1 - fy) + bot * fy
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("faces", nargs=6,
                    help="+x -x +y -y +z -z images")
    ap.add_argument("--output", required=True)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--equirect-height", type=int, default=128)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the prefilter (cuda or cpu)")
    args = ap.parse_args(argv)

    faces = [_load(p) * args.scale for p in args.faces]
    dirs = cube_sample_dirs(args.equirect_height)
    equirect = sample_cube(faces, dirs)
    bake(equirect, args.output, args.size, args.samples, args.device)
    print(f"wrote {args.output} (cube -> equirect "
          f"{equirect.shape[1]}x{equirect.shape[0]} -> GGX chain "
          f"{args.size})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
