"""FFT module (port of granite_tpu/ops/fft.py; reference:
renderer/fft/fft.{hpp,cpp}, a GLFFT-derived Vulkan compute FFT).

The reference's API surface (Domain/Direction, fft_1d/2d/3d, r2c/c2r)
over torch.fft, gated against numpy with the reference's SNR test
(squared error <= 1e-10 * signal power, fft/test/fft_test.cpp:70-93).
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class Domain(enum.Enum):
    COMPLEX = 0
    REAL = 1


class Direction(enum.Enum):
    FORWARD = 0
    INVERSE = 1


def fft_1d(x, direction: Direction = Direction.FORWARD, axis: int = -1):
    if direction == Direction.FORWARD:
        return torch.fft.fft(x, dim=axis)
    return torch.fft.ifft(x, dim=axis)


def fft_2d(x, direction: Direction = Direction.FORWARD):
    if direction == Direction.FORWARD:
        return torch.fft.fft2(x)
    return torch.fft.ifft2(x)


def fft_3d(x, direction: Direction = Direction.FORWARD):
    dims = (-3, -2, -1)
    if direction == Direction.FORWARD:
        return torch.fft.fftn(x, dim=dims)
    return torch.fft.ifftn(x, dim=dims)


def r2c_1d(x, axis: int = -1):
    return torch.fft.rfft(x, dim=axis)


def c2r_1d(x, n: int, axis: int = -1):
    return torch.fft.irfft(x, n=n, dim=axis)


def r2c_2d(x):
    return torch.fft.rfft2(x)


def c2r_2d(x, shape):
    return torch.fft.irfft2(x, s=shape)


def snr_check(result, reference, gate: float = 1e-10) -> bool:
    """The reference's numeric gate: err <= gate * power."""
    r = result.cpu().numpy() if isinstance(result, torch.Tensor) \
        else np.asarray(result)
    ref = reference.cpu().numpy() if isinstance(reference, torch.Tensor) \
        else np.asarray(reference)
    err = float(np.sum(np.abs(r - ref) ** 2))
    power = float(np.sum(np.abs(ref) ** 2))
    return err <= gate * max(power, 1e-30)
