"""Per-channel and luma PSNR compare (copy of
granite_tpu/utils/image_compare.py; reference:
tools/image_compare.cpp:108-250).

PSNR per R/G/B channel, BT.601 luma PSNR and the RMSE in percent of full
scale (the counters `--png-reference-path` writes into the stat JSON),
and an amplified x16 diff image for inspection.
"""

from __future__ import annotations

import numpy as np


def psnr_channels(a: np.ndarray, b: np.ndarray) -> dict[str, float]:
    a = np.asarray(a, dtype=np.float32)[..., :3] / 255.0
    b = np.asarray(b, dtype=np.float32)[..., :3] / 255.0
    out = {}
    for i, name in enumerate("RGB"):
        mse = float(np.mean((a[..., i] - b[..., i]) ** 2))
        out[f"psnr{name}"] = 10.0 * np.log10(1.0 / mse) if mse > 0 else 99.0
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    la = a @ luma
    lb = b @ luma
    mse = float(np.mean((la - lb) ** 2))
    out["psnrLuma"] = 10.0 * np.log10(1.0 / mse) if mse > 0 else 99.0
    out["rmsePercent"] = 100.0 * float(np.sqrt(np.mean((a - b) ** 2)))
    return out


def diff_image(a: np.ndarray, b: np.ndarray, amplify: float = 16.0):
    a = np.asarray(a, dtype=np.float32)[..., :3]
    b = np.asarray(b, dtype=np.float32)[..., :3]
    return np.clip(np.abs(a - b) * amplify, 0, 255).astype(np.uint8)
