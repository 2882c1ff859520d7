"""Audio DSP helpers (copy of granite_tpu/audio/dsp.py, unchanged code;
reference: audio/dsp/ — sinc resampler, tone
filter, pole-zero).  Numpy implementations with the same roles: offline
or mix-thread sample-rate conversion and simple filtering."""

from __future__ import annotations

import numpy as np


def sinc_resample(x: np.ndarray, src_rate: float, dst_rate: float,
                  taps: int = 16) -> np.ndarray:
    """Windowed-sinc sample-rate conversion (audio/dsp/sinc_resampler.*).

    x: (N,) or (N, C) float; returns resampled along axis 0."""
    x = np.asarray(x, np.float32)
    mono = x.ndim == 1
    if mono:
        x = x[:, None]
    n_out = int(round(len(x) * dst_rate / src_rate))
    ratio = src_rate / dst_rate
    t = np.arange(n_out) * ratio                 # source positions
    i0 = np.floor(t).astype(int)
    out = np.zeros((n_out, x.shape[1]), np.float32)
    half = taps // 2
    # cutoff at the lower Nyquist for downsampling
    cutoff = min(1.0, dst_rate / src_rate)
    for k in range(-half + 1, half + 1):
        idx = np.clip(i0 + k, 0, len(x) - 1)
        d = t - (i0 + k)
        w = cutoff * np.sinc(cutoff * d) * _hann(d, half)
        out += x[idx] * w[:, None].astype(np.float32)
    return out[:, 0] if mono else out


def _hann(d: np.ndarray, half: int) -> np.ndarray:
    w = 0.5 + 0.5 * np.cos(np.pi * np.clip(d / half, -1.0, 1.0))
    return np.where(np.abs(d) <= half, w, 0.0)


def one_pole_filter(x: np.ndarray, coeff: float) -> np.ndarray:
    """One-pole lowpass y[n] = (1-c) x[n] + c y[n-1]
    (audio/dsp/tone_filter pole building block) via scan."""
    x = np.asarray(x, np.float32)
    y = np.empty_like(x)
    acc = np.zeros(x.shape[1:], np.float32)
    a = np.float32(1.0 - coeff)
    c = np.float32(coeff)
    for n in range(len(x)):
        acc = a * x[n] + c * acc
        y[n] = acc
    return y
