"""Split-sum BRDF LUT baker (port of tools/brdf_lut_generate.py;
reference: tools/brdf_lut_generate.cpp, which integrates the GGX
environment BRDF into a (NoV, roughness) -> (scale, bias) LUT and writes
it to a texture file).

  python -m granite_tpu_torch.tools.brdf_lut_generate --output brdf.npy
      [--size 256] [--samples 512] [--gtpx brdf.gtpx] [--png brdf.png]
      [--device cuda]

The .npy is (S, S, 2) f32: x = NoV, y = roughness, channels = F0
scale / bias of the split-sum approximation.  The integration runs in
torch float64 on --device (default cuda; cpu runs it on the host).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core.device import resolve_device
from ..renderer.environment import radical_inverse_vdc


def integrate_brdf(size: int, samples: int, device="cpu") -> np.ndarray:
    """Split-sum integration (brdf_lut_generate.cpp IntegrateBRDF;
    geometry term uses the IBL k = a^2/2 variant) in float64 on `device`:
    each sample's angles on the host, the (roughness, NoV) grid on the
    device, accumulated over the samples in order.  -> (S, S, 2) float32
    on the host."""
    dev = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    nov = (torch.arange(size, **f64) + 0.5) / size
    NoV = nov[None, :]                                      # (1, S)
    a = ((nov * nov)[:, None])                              # (S, 1)
    Vx = torch.sqrt(1.0 - NoV * NoV)                        # V = (Vx, 0, NoV)

    i = np.arange(samples)
    xi1 = (i + 0.5) / samples
    xi2 = radical_inverse_vdc(i)

    scale = torch.zeros((size, size), **f64)
    bias = torch.zeros((size, size), **f64)
    k = (a * a) / 2.0                                       # (S, 1)
    NoVv = NoV.clamp(1e-4, 1.0)                             # (1, S)
    g_v = NoVv / (NoVv * (1.0 - k) + k)
    for s in range(samples):
        phi = 2.0 * np.pi * xi1[s]
        cos_t = torch.sqrt((1.0 - xi2[s])
                           / (1.0 + (a * a - 1.0) * xi2[s]))   # (S, 1)
        sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
        hx = float(np.cos(phi)) * sin_t
        VoH = Vx * hx + NoV * cos_t                         # (S, S)
        NoL = (2.0 * VoH * cos_t - NoV).clamp(0.0, 1.0)
        NoH = cos_t.clamp(0.0, 1.0)
        VoH = VoH.clamp(0.0, 1.0)
        g_l = NoL / (NoL * (1.0 - k) + k)
        g_vis = torch.where(NoL > 0, g_l * g_v * VoH
                            / (NoH * NoVv).clamp_min(1e-6), 0.0)
        fc = (1.0 - VoH) ** 5
        scale += (1.0 - fc) * g_vis
        bias += fc * g_vis
    out = torch.stack([scale, bias], dim=-1) / samples
    return out.cpu().numpy().astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True, help=".npy LUT")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--gtpx", default=None,
                    help="also write an rgba8 GTPX (rg = scale/bias)")
    ap.add_argument("--png", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the integration (cuda or cpu)")
    args = ap.parse_args(argv)

    lut = integrate_brdf(args.size, args.samples, args.device)
    np.save(args.output, lut)
    print(f"wrote {args.output} ({args.size}x{args.size}x2 f32)")
    if args.gtpx or args.png:
        u8 = np.zeros((args.size, args.size, 4), np.uint8)
        u8[..., :2] = np.clip(lut * 255 + 0.5, 0, 255).astype(np.uint8)
        u8[..., 3] = 255
        if args.gtpx:
            from ..native.texture import gtpx_save
            gtpx_save(args.gtpx, u8.tobytes(), "rgba8", args.size,
                      args.size)
            print(f"wrote {args.gtpx}")
        if args.png:
            from ..utils.image_io import save_png
            save_png(args.png, u8)
            print(f"wrote {args.png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
