"""FXAA 3.11, "PC quality" preset (port of granite_tpu/ops/fxaa.py;
reference renderer/post/fxaa.cpp + assets/shaders/post/fxaa.frag).

Every pixel runs the same fixed tap sequence (a 12-step edge search each
way, masked where the edge test fails): 25 bilinear taps of the LDR
image, fetched from one quad-packed copy.  Plain PyTorch: the reference
is jnp, not a Pallas kernel.

Operates on tonemapped LDR RGB in [0, 1]; luma = dot(rgb, (0.299, 0.587,
0.114)).
"""

from __future__ import annotations

import torch

from .hdr import sample_bilinear_packed, shift
from .texture import quad_pack2d

EDGE_THRESHOLD = 1.0 / 8.0
EDGE_THRESHOLD_MIN = 1.0 / 24.0
SUBPIX_QUALITY = 0.75
_STEPS = [1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0]
_LUMA = (0.299, 0.587, 0.114)


def _luma(rgb):
    # Written out rather than a product with a weight tensor, which would
    # cost a host-to-device copy per call on the card.
    return rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1] \
        + rgb[..., 2] * _LUMA[2]


def fxaa(rgb, width: int, height: int):
    """(H, W, 3) LDR -> antialiased (H, W, 3)."""
    packed = quad_pack2d(rgb)
    C = rgb.shape[-1]
    L = _luma(rgb)
    lN = shift(L, -1, 0)
    lS = shift(L, 1, 0)
    lW = shift(L, 0, -1)
    lE = shift(L, 0, 1)
    l_min = torch.minimum(L, torch.minimum(torch.minimum(lN, lS),
                                           torch.minimum(lW, lE)))
    l_max = torch.maximum(L, torch.maximum(torch.maximum(lN, lS),
                                           torch.maximum(lW, lE)))
    rng = l_max - l_min
    active = rng >= torch.clamp_min(l_max * EDGE_THRESHOLD,
                                    EDGE_THRESHOLD_MIN)

    lNW = shift(L, -1, -1)
    lNE = shift(L, -1, 1)
    lSW = shift(L, 1, -1)
    lSE = shift(L, 1, 1)

    # Horizontal/vertical edge estimation (FXAA 3.11).
    edge_h = ((-2 * lW + lNW + lSW).abs() + 2 * (-2 * L + lN + lS).abs()
              + (-2 * lE + lNE + lSE).abs())
    edge_v = ((-2 * lN + lNW + lNE).abs() + 2 * (-2 * L + lW + lE).abs()
              + (-2 * lS + lSW + lSE).abs())
    is_horiz = edge_h >= edge_v     # edge runs horizontally -> step in y

    l1 = torch.where(is_horiz, lN, lW)
    l2 = torch.where(is_horiz, lS, lE)
    grad1 = l1 - L
    grad2 = l2 - L
    steepest1 = grad1.abs() >= grad2.abs()
    grad_scaled = 0.25 * torch.maximum(grad1.abs(), grad2.abs())

    inv_w = 1.0 / width
    inv_h = 1.0 / height
    step_len = torch.where(is_horiz, inv_h, inv_w)
    step_len = torch.where(steepest1, -step_len, step_len)
    l_local_avg = torch.where(steepest1, 0.5 * (l1 + L), 0.5 * (l2 + L))

    dev = rgb.device
    u = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) * inv_w
    v = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) \
        * inv_h
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    # Move half a pixel toward the edge.
    cu = torch.where(is_horiz, uu, uu + 0.5 * step_len)
    cv = torch.where(is_horiz, vv + 0.5 * step_len, vv)

    # Edge-aligned direction.
    du = torch.where(is_horiz, inv_w, 0.0)
    dv = torch.where(is_horiz, 0.0, inv_h)

    def edge_search(sign):
        dist = torch.zeros_like(L)
        done = torch.zeros_like(L, dtype=torch.bool)
        end_luma = torch.zeros_like(L)
        acc = torch.zeros_like(L)
        for s in _STEPS:
            acc = acc + torch.where(done, 0.0, s)
            pu = cu + sign * du * acc
            pv = cv + sign * dv * acc
            lum = _luma(sample_bilinear_packed(packed, C, pu, pv))
            delta = lum - l_local_avg
            reached = delta.abs() >= grad_scaled
            end_luma = torch.where(done, end_luma, delta)
            dist = torch.where(done, dist, acc)
            done = done | reached
        return dist, end_luma

    dist_p, luma_p = edge_search(+1.0)
    dist_n, luma_n = edge_search(-1.0)

    closer_p = dist_p < dist_n
    dist_final = torch.minimum(dist_p, dist_n)
    edge_len = dist_p + dist_n
    pixel_offset = -dist_final / edge_len.clamp_min(1e-6) + 0.5

    l_center_below = L < l_local_avg
    end_delta = torch.where(closer_p, luma_p, luma_n)
    good_span = (end_delta < 0) != l_center_below
    pixel_offset = torch.where(good_span, pixel_offset, 0.0)

    # Subpixel aliasing.
    l_avg = (1.0 / 12.0) * (2 * (lN + lS + lW + lE)
                            + lNW + lNE + lSW + lSE)
    sub = ((l_avg - L).abs() / rng.clamp_min(1e-6)).clamp(0.0, 1.0)
    sub = (-2.0 * sub + 3.0) * sub * sub
    sub = sub * sub * SUBPIX_QUALITY
    offset = torch.maximum(pixel_offset, sub) * step_len.abs() \
        * torch.sign(step_len)

    fu = torch.where(is_horiz, uu, uu + offset)
    fv = torch.where(is_horiz, vv + offset, vv)
    out = sample_bilinear_packed(packed, C, fu, fv)
    return torch.where(active[..., None], out, rgb)
