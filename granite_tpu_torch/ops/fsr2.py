"""FSR2-style temporal upscaling, postAA "taaFSR2" (port of
granite_tpu/ops/fsr2.py; reference renderer/post/temporal.hpp
setup_fsr2_pass + post/aa.cpp).

Jittered render-size colour + depth + motion vectors in, a display-size
anti-aliased image out: each display pixel fetches one quad-packed
payload of the render-size frame (TAA-space colour, rounded
neighbourhood min/max, motion dilated toward the nearest depth) at its
jittered position, reprojects the display-size history, and accumulates
with a weight peaked where the jittered sample lands on it; an RCAS-style
contrast-adaptive sharpen follows.  Plain PyTorch: the reference is jnp,
not a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .hdr import _sample_bilinear_uv, clamped_floor, shift, uv_grid
from .taa import (
    _clamp_box_aabb, clamp_taa_range, dilate_motion, hdr_to_taa,
    neighborhood_bounds, taa_to_hdr,
)
from .texture import quad_pack2d

SHARPNESS = 0.5         # RCAS strength after the accumulation


def halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    while index > 0:
        f /= base
        r += f * (index % base)
        index //= base
    return r


def fsr2_jitter_phases(render_w: int, display_w: int) -> np.ndarray:
    """Halton(2, 3) jitter sequence of ceil(8 * (display / render)^2)
    phases (at least 2), centred on 0."""
    scale = display_w / max(render_w, 1)
    n = max(int(np.ceil(8.0 * scale * scale)), 2)
    return np.array([[halton(i + 1, 2) - 0.5, halton(i + 1, 3) - 0.5]
                     for i in range(n)], np.float32)


def rcas_sharpen(img):
    """Robust contrast-adaptive sharpening: 5-tap cross, the negative lobe
    scaled by the local contrast headroom, clamped to the local min/max."""
    n = shift(img, -1, 0)
    s = shift(img, 1, 0)
    w_ = shift(img, 0, -1)
    e = shift(img, 0, 1)
    mn = torch.minimum(torch.minimum(torch.minimum(n, s),
                                     torch.minimum(w_, e)), img)
    mx = torch.maximum(torch.maximum(torch.maximum(n, s),
                                     torch.maximum(w_, e)), img)
    hit_min = mn / (4.0 * mx).clamp_min(1e-6)
    # The denominator stays away from 0 where the neighbourhood is flat
    # at 1.0 (0 / 0 otherwise).
    hit_max = (1.0 - mx) / (4.0 * mn.clamp_max(1.0) - 4.0).clamp_max(-1e-6)
    lobe_limit = torch.maximum(-hit_min, hit_max).amax(-1, keepdim=True)
    lobe = lobe_limit.clamp(-0.1875, 0.0) * SHARPNESS
    out = (img + lobe * (n + s + w_ + e)) / (1.0 + 4.0 * lobe)
    return torch.minimum(torch.maximum(out, mn), mx)


def fsr2_upscale(color_lr, depth_lr, mv_lr, history_hr, jitter_uv,
                 out_h: int, out_w: int):
    """One upscale step.

    color_lr: (h, w, 3) linear HDR of the jittered render; depth_lr:
    (h, w) reverse-Z; mv_lr: (h, w, 2) uv motion vectors; history_hr:
    (out_h, out_w, 4) TAA-space history colour + accumulation weight;
    jitter_uv: (2,) this frame's jitter in UV units (the clip translation
    TemporalJitter applied).
    -> (out_hdr (out_h, out_w, 3), new_history (out_h, out_w, 4))."""
    cur = hdr_to_taa(color_lr)
    best_mv = dilate_motion(depth_lr, mv_lr)
    lo, hi = neighborhood_bounds(cur)

    packed = quad_pack2d(torch.cat([cur, lo, hi, best_mv], dim=-1))
    h, w = color_lr.shape[:2]
    uu, vv = uv_grid(out_h, out_w, color_lr.device)
    # The jittered camera moves every image point by +jitter_uv, so the
    # scene at display uv lies at uv + jitter_uv in the render.
    x = (uu + jitter_uv[0]) * w - 0.5
    y = (vv + jitter_uv[1]) * h - 0.5
    x0 = clamped_floor(x, w - 1)
    y0 = clamped_floor(y, h - 1)
    fx = (x - x0).clamp(0.0, 1.0)[..., None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None]
    quad = packed[y0.long(), x0.long()].reshape(y0.shape + (4, 11))
    samp = ((quad[..., 0, :] * (1 - fx) + quad[..., 1, :] * fx) * (1 - fy)
            + (quad[..., 2, :] * (1 - fx) + quad[..., 3, :] * fx) * fy)
    cur_hr = samp[..., 0:3]
    lo_hr = samp[..., 3:6]
    hi_hr = samp[..., 6:9]
    mv_hr = samp[..., 9:11]

    # Alignment confidence: display pixels on a jittered sample trust it.
    d2 = (torch.minimum(fx, 1 - fx) ** 2
          + torch.minimum(fy, 1 - fy) ** 2)[..., 0]
    conf = torch.exp(-32.0 * d2)

    old_u = uu - mv_hr[..., 0]
    old_v = vv - mv_hr[..., 1]
    hist4 = _sample_bilinear_uv(history_hr, old_u, old_v)
    history = clamp_taa_range(hist4[..., :3])
    hist_w = hist4[..., 3].clamp_min(0.0)
    mv_len = torch.sqrt((mv_hr * mv_hr).sum(-1) + 1e-20)
    mv_fast = (mv_len * 50.0).clamp_max(1.0)
    # Detail lock: pixels this frame's samples miss keep their history
    # unless it moves.
    rect = _clamp_box_aabb(history, lo_hr, hi_hr)
    keep = ((1.0 - conf) * (1.0 - mv_fast))[..., None]
    history = rect + (history - rect) * keep
    on_screen = (old_u >= 0) & (old_u <= 1) & (old_v >= 0) & (old_v <= 1)
    history = torch.where(on_screen[..., None], history, cur_hr)
    hist_w = torch.where(on_screen, hist_w, torch.zeros_like(hist_w))

    # Alignment-weighted running average; motion shortens the memory.
    w_cur = torch.exp(-128.0 * d2) + 1e-3
    decay = 0.97 * (1.0 - 0.6 * mv_fast)
    w_prev = hist_w * decay
    alpha = (w_cur / (w_prev + w_cur))[..., None]
    acc = history + (cur_hr - history) * alpha
    new_w = (w_prev + w_cur).clamp_max(16.0)
    return (rcas_sharpen(taa_to_hdr(acc)),
            torch.cat([acc, new_w[..., None]], dim=-1))
