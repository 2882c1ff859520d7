"""HDR post chain (port of granite_tpu/ops/hdr.py; reference
renderer/post/hdr.cpp:308 and the bloom/luminance/tonemap shaders).

threshold at 1/2 res (rgb = max(color/lum * (lum - 8*avg), 0),
a = log2 lum) -> luminance (mean log2 lum clamped to [-3, 2], smoothed
by 1-0.5^dt) -> 4 bloom downsamples (9 taps at +-1.75 texels, the first
with temporal feedback 1-0.001^dt) -> 2 upsamples (+-0.875 texels) ->
Uncharted2 filmic tonemap (white 11.2).  Exact 2:1 and integer ratios
take the gather-free separable forms, others the bilinear tap form,
as in the reference.  After an upscale to display size the tonemapped
image gets the 4-neighbour unsharp mask (`sharpen`).
"""

from __future__ import annotations

import numpy as np
import torch

from .texture import quad_pack2d

LUM_MIN_LOG = -3.0
LUM_MAX_LOG = 2.0


def clamped_floor(x, hi: int):
    """floor(x) clamped to [0, hi], still float.  Clamping before the int
    cast saturates +-inf and coordinates past the int32 range to the edge
    texel, as XLA's float->int conversion does (a plain torch cast maps
    them all to INT_MIN, i.e. texel 0); NaN goes to texel 0."""
    return torch.nan_to_num(torch.floor(x), nan=0.0).clamp(0, hi)


def shift(img, dy: int, dx: int):
    """out[y, x] = img[clamp(y + dy), clamp(x + dx)] (edge padding) for an
    (H, W, ...) image: the reference's pad-and-slice `_shift`."""
    h, w = img.shape[:2]
    if dy:
        k = min(abs(dy), h)
        edge = (img[-1:] if dy > 0 else img[:1]).expand(k, *img.shape[1:])
        img = torch.cat([img[k:], edge] if dy > 0 else [edge, img[:h - k]])
    if dx:
        k = min(abs(dx), w)
        edge = (img[:, -1:] if dx > 0 else img[:, :1]) \
            .expand(h, k, *img.shape[2:])
        img = torch.cat([img[:, k:], edge] if dx > 0
                        else [edge, img[:, :w - k]], dim=1)
    return img


def _sample_bilinear_uv(img, u, v):
    """Bilinear sample of (H, W, C) at normalized UV, clamp-to-edge."""
    return sample_bilinear_packed(quad_pack2d(img), img.shape[-1], u, v)


def sample_bilinear_packed(packed, C: int, u, v):
    """_sample_bilinear_uv on an image already quad-packed
    (ops/texture.quad_pack2d), for callers that fetch one image often."""
    h, w = packed.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = clamped_floor(x, w - 1)
    y0 = clamped_floor(y, h - 1)
    fx = (x - x0).clamp(0.0, 1.0)[..., None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None]
    quad = packed[y0.long(), x0.long()].reshape(y0.shape + (4, C))
    return ((quad[..., 0, :] * (1 - fx) + quad[..., 1, :] * fx) * (1 - fy)
            + (quad[..., 2, :] * (1 - fx) + quad[..., 3, :] * fx) * fy)


def _upsample_axis_int(img, f: int, axis: int, rows=None):
    """Exact integer-factor bilinear upsample along one axis: output
    texel r * f + p is the fixed phase-p blend of input texels r + k and
    r + k + 1 (edge clamped).  rows (y0, y1): only those output texels
    of the axis (default all n * f), each computed as in the whole."""
    img = img.movedim(axis, 0)
    n = img.shape[0]
    y0, y1 = (0, n * f) if rows is None else rows
    out = img.new_empty((y1 - y0,) + img.shape[1:])
    for p in range(f):
        first = y0 + (p - y0) % f
        if first >= y1:
            continue
        phi = (p + 0.5) / f - 0.5
        k = -1 if phi < 0 else 0
        t = phi - k
        r = torch.arange(first, y1, f, device=img.device) // f
        a = img[(r + k).clamp(0, n - 1)]
        b = img[(r + k + 1).clamp(0, n - 1)]
        out[first - y0::f] = a * (1 - t) + b * t
    return out.movedim(0, axis)


def _downsample2_axis(img, kernel, axis: int):
    """Stride-2 separable filter over input texels [2o-2 .. 2o+3]."""
    img = img.movedim(axis, 0)
    n = img.shape[0]
    pad = torch.cat([img[:1], img[:1], img, img[-1:], img[-1:]])
    acc = 0.0
    for j, w in enumerate(kernel):
        acc = acc + w * pad[j:j + n:2]
    return acc.movedim(0, axis)


def _upsample2_axis(img, axis: int):
    """The bloom 2x upsample as two fixed 4-tap phase kernels."""
    k_even = (0.03125, 0.34375, 0.46875, 0.15625)
    k_odd = (0.15625, 0.46875, 0.34375, 0.03125)
    img = img.movedim(axis, 0)
    n = img.shape[0]
    pad = torch.cat([img[:1], img[:1], img, img[-1:], img[-1:]])
    even = sum(w * pad[j:j + n] for j, w in enumerate(k_even))
    odd = sum(w * pad[j + 1:j + 1 + n] for j, w in enumerate(k_odd))
    out = torch.stack([even, odd], dim=1).reshape((2 * n,) + img.shape[1:])
    return out.movedim(0, axis)


def uv_grid(out_h: int, out_w: int, device, rows=None):
    """Texel-centre uv of an out_h x out_w grid; rows (y0, y1) gives only
    those rows (the same values as the whole grid's)."""
    y0, y1 = (0, out_h) if rows is None else rows
    u = (torch.arange(out_w, dtype=torch.float32, device=device) + 0.5) \
        / out_w
    v = (torch.arange(y0, y1, dtype=torch.float32, device=device) + 0.5) \
        / out_h
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return uu, vv


def resize_bilinear(img, out_h: int, out_w: int, rows=None):
    """Bilinear resize of (H, W, C) to (out_h, out_w, C); rows (y0, y1)
    computes only those output rows, each as the whole resize computes
    it (the row-banded frame of parallel/framebuffer_sharding.py)."""
    h, w = img.shape[:2]
    if out_h == h and out_w == w:
        return img if rows is None else img[rows[0]:rows[1]]
    if h == 2 * out_h and w == 2 * out_w:
        if rows is not None:
            img = img[2 * rows[0]:2 * rows[1]]
            out_h = rows[1] - rows[0]
        return img.reshape(out_h, 2, out_w, 2, -1).mean(dim=(1, 3)) \
            .reshape(out_h, out_w, img.shape[-1])
    if out_h % h == 0 and out_w % w == 0 and out_h // h == out_w // w:
        return _upsample_axis_int(
            _upsample_axis_int(img, out_h // h, 0, rows), out_w // w, 1)
    uu, vv = uv_grid(out_h, out_w, img.device, rows)
    return _sample_bilinear_uv(img, uu, vv)


def bloom_threshold(hdr, avg_linear_lum, out_h: int, out_w: int,
                    dynamic_exposure: bool = True, rows=None):
    """rows (y0, y1): only those rows of the (out_h, out_w) output."""
    half = resize_bilinear(hdr, out_h, out_w, rows)
    lum = half.max(dim=-1).values + 1e-4
    loglum = torch.log2(lum)
    color = half / lum[..., None]
    thresh = lum - (8.0 * avg_linear_lum if dynamic_exposure else 8.0)
    rgb = (color * thresh[..., None]).clamp_min(0.0)
    return torch.cat([rgb, loglum[..., None]], dim=-1)


def _host_lerp(base: float, frame_time: float) -> float:
    """1 - base^frame_time in float32, on the host (a factor of the lerp
    towards this frame's value; no tensor made, nothing copied)."""
    return float(np.float32(1.0) - np.power(np.float32(base),
                                            np.float32(frame_time)))


def average_log_luminance(threshold_out, old_log_lum, frame_time,
                          mean=torch.mean):
    """mean: the reduction over the threshold target's pixels (a row band
    passes the band's sum and count through an all_reduce,
    graph.render_graph.PassContext.mean)."""
    avg = mean(threshold_out[..., 3]).clamp(LUM_MIN_LOG, LUM_MAX_LOG)
    lerp = _host_lerp(0.5, frame_time)
    return old_log_lum + (avg - old_log_lum) * lerp


_DOWN_TAPS = [(0.25, 0.0, 0.0),
              (0.0625, -1.75, 1.75), (0.125, 0.0, 1.75),
              (0.0625, 1.75, 1.75), (0.125, -1.75, 0.0),
              (0.125, 1.75, 0.0), (0.0625, -1.75, -1.75),
              (0.125, 0.0, -1.75), (0.0625, 1.75, -1.75)]

_UP_TAPS = [(0.25, 0.0, 0.0),
            (0.0625, -0.875, 0.875), (0.125, 0.0, 0.875),
            (0.0625, 0.875, 0.875), (0.125, -0.875, 0.0),
            (0.125, 0.875, 0.0), (0.0625, -0.875, -0.875),
            (0.125, 0.0, -0.875), (0.0625, 0.875, -0.875)]

_DOWN2_KERNEL = (0.0625, 0.1875, 0.25, 0.25, 0.1875, 0.0625)


def _taps(img, out_h: int, out_w: int, taps):
    in_h, in_w = img.shape[:2]
    uu, vv = uv_grid(out_h, out_w, img.device)
    acc = 0.0
    for wgt, dx, dy in taps:
        acc = acc + wgt * _sample_bilinear_uv(img, uu + dx / in_w,
                                              vv + dy / in_h)
    return acc


def bloom_downsample(img, out_h: int, out_w: int, history=None,
                     frame_time=None):
    in_h, in_w = img.shape[:2]
    if in_h == 2 * out_h and in_w == 2 * out_w:
        out = _downsample2_axis(
            _downsample2_axis(img, _DOWN2_KERNEL, 0), _DOWN2_KERNEL, 1)
    else:
        out = _taps(img, out_h, out_w, _DOWN_TAPS)
    if history is not None:
        lerp = _host_lerp(0.001, frame_time)
        out = history + (out - history) * lerp
    return out


def bloom_upsample(img, out_h: int, out_w: int):
    in_h, in_w = img.shape[:2]
    if out_h == 2 * in_h and out_w == 2 * in_w:
        return _upsample2_axis(_upsample2_axis(img, 0), 1)
    return _taps(img, out_h, out_w, _UP_TAPS)


_A, _B, _C, _D, _E, _F, _W = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30, 11.2


def _uncharted2(x):
    return ((x * (_A * x + _C * _B) + _D * _E)
            / (x * (_A * x + _B) + _D * _F)) - _E / _F


def tonemap(hdr, bloom, avg_log_lum=None, rows=None):
    """hdr + bilinearly upsampled bloom, exposure exp2(-avg log lum),
    Uncharted2 filmic curve; rows (y0, y1): only those rows of it."""
    h, w = hdr.shape[:2]
    if rows is not None:
        hdr = hdr[rows[0]:rows[1]]
    if bloom is not None:
        if bloom.shape[:2] != (h, w) or rows is not None:
            bloom = resize_bilinear(bloom, h, w, rows)
        hdr = hdr + bloom[..., :3]
    if avg_log_lum is not None:
        hdr = hdr * torch.exp2(-avg_log_lum)
    white_scale = 1.0 / ((_W * (_A * _W + _C * _B) + _D * _E)
                         / (_W * (_A * _W + _B) + _D * _F) - _E / _F)
    return _uncharted2(hdr) * white_scale


def sharpen(img):
    """Post-upscale sharpen: unsharp mask (weight 0.25) over the
    4-neighbour laplacian (edge clamped), clipped to [0, 1]."""
    lap = 4.0 * img
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        lap = lap - shift(img, dy, dx)
    return (img + 0.25 * lap).clamp(0.0, 1.0)
