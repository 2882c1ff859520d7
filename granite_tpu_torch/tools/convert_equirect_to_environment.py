"""Offline IBL convolver CLI (port of
tools/convert_equirect_to_environment.py; reference:
tools/convert_equirect_to_environment.cpp, which bakes an equirect HDR
into a GGX-prefiltered reflection chain + cosine-convolved irradiance and
writes .gtx cubemaps; here one GENV1 .npz bundle that
renderer.environment.Environment(baked=...) loads).

  python -m granite_tpu_torch.tools.convert_equirect_to_environment
      input.{npy,png,hdr} --output env.genv.npz [--size 64]
      [--samples 64] [--scale 1.0] [--reflection refl.npy]
      [--irradiance irr.npy] [--device cuda]

The reflection chain is prefiltered in torch on --device (default cuda;
cpu bakes on the host).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core.device import resolve_device
from ..renderer.environment import save_baked_environment
from ..utils.image_io import load_image


def load_equirect(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)[..., :3]
    img = load_image(path, srgb_to_linear=True)
    return np.asarray(img, np.float32)[..., :3]


def bake(env: np.ndarray, output: str, size: int, samples: int,
         device) -> dict:
    """env (H, W, 3) radiance -> the GENV1 bundle at `output`, its
    reflection chain prefiltered on `device`.  -> the saved arrays."""
    env_t = torch.as_tensor(np.ascontiguousarray(env, np.float32),
                            device=resolve_device(device))
    return save_baked_environment(output, env_t, base_size=size,
                                  samples=samples)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("equirect")
    ap.add_argument("--output", required=True,
                    help=".genv.npz bundle for Environment(baked=...)")
    ap.add_argument("--size", type=int, default=64,
                    help="reflection level-0 resolution (square)")
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="radiance scale (tool --cube-scale analogue)")
    ap.add_argument("--reflection", default=None,
                    help="also dump the reflection chain as .npy list")
    ap.add_argument("--irradiance", default=None,
                    help="also dump the irradiance map as .npy")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the prefilter (cuda or cpu)")
    args = ap.parse_args(argv)

    env = load_equirect(args.equirect) * args.scale
    baked = bake(env, args.output, args.size, args.samples, args.device)
    if args.reflection:
        np.save(args.reflection,
                np.asarray(baked["reflection_0"], np.float32))
    if args.irradiance:
        np.save(args.irradiance, baked["irradiance"])
    print(f"baked {args.output}: {baked['num_levels']} reflection levels "
          f"at {args.size}^2, SH9 + 32x64 irradiance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
