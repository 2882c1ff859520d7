"""SMAA 1x — subpixel morphological anti-aliasing (port of
granite_tpu/ops/smaa.py; reference renderer/post/smaa.cpp +
assets/shaders/post/smaa/*).

Three passes: (1) luma edge detection with local contrast adaptation,
(2) blending weights from edge run lengths (orthogonal L/Z shapes with
the analytic AreaTex, 45-degree staircases, sharp-corner rounding),
(3) neighbourhood blending.  Searches are fixed MAX_SEARCH-step shift
chains over the whole image.  Plain PyTorch: the reference is jnp, not a
Pallas kernel.
"""

from __future__ import annotations

import torch

from .hdr import shift

EDGE_THRESHOLD = 0.1
LOCAL_CONTRAST_FACTOR = 2.0
MAX_SEARCH = 8
MAX_SEARCH_DIAG = 4
CORNER_ROUNDING = 0.25          # SMAA_CORNER_ROUNDING 25 (smaa.h)
_LUMA = (0.2126, 0.7152, 0.0722)


def _luma(rgb):
    # Written out rather than a product with a weight tensor, which would
    # cost a host-to-device copy per call on the card.
    return rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1] \
        + rgb[..., 2] * _LUMA[2]


def edge_detection(rgb):
    """Luma edges with local contrast adaptation -> (edges_left,
    edges_top) (H, W) bool: an edge on the pixel's LEFT/TOP border."""
    L = _luma(rgb)
    l_left = shift(L, 0, -1)
    l_top = shift(L, -1, 0)
    d_left = (L - l_left).abs()
    d_top = (L - l_top).abs()
    e_left = d_left >= EDGE_THRESHOLD
    e_top = d_top >= EDGE_THRESHOLD
    # local contrast adaptation: discard edges much weaker than the
    # strongest neighbour delta.
    l_right = shift(L, 0, 1)
    l_bottom = shift(L, 1, 0)
    l_leftleft = shift(L, 0, -2)
    l_toptop = shift(L, -2, 0)
    max_l = torch.maximum((L - l_right).abs(), (l_left - l_leftleft).abs())
    max_t = torch.maximum((L - l_bottom).abs(), (l_top - l_toptop).abs())
    cmax = torch.maximum(max_l, max_t)
    e_left = e_left & (d_left >= cmax / LOCAL_CONTRAST_FACTOR)
    e_top = e_top & (d_top >= cmax / LOCAL_CONTRAST_FACTOR)
    return e_left, e_top


def _run_length(edge, step_dy: int, step_dx: int, steps: int = MAX_SEARCH):
    """Length of the run continuing from each pixel in one direction,
    capped at `steps`."""
    dist = torch.zeros(edge.shape, dtype=torch.float32, device=edge.device)
    running = torch.ones_like(edge)
    for i in range(1, steps + 1):
        running = running & shift(edge, step_dy * i, step_dx * i)
        dist = dist + running.to(torch.float32)
    return dist


def _gather_x(img, xi):
    """img[y, xi[y, x]] with xi clamped to the row."""
    return torch.gather(img, 1, xi.clamp(0, img.shape[1] - 1))


def _gather_y(img, yi):
    return torch.gather(img, 0, yi.clamp(0, img.shape[0] - 1))


def _mean_pos(a, b):
    """Mean of max(y, 0) over the linear segment from a to b."""
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    hi_pos = hi.clamp_min(0.0)
    lo_pos = lo.clamp_min(0.0)
    flat = (hi - lo).abs() < 1e-6
    denom = torch.where(flat, 1.0, hi - lo)
    frac = (hi_pos / denom.clamp_min(1e-6)).clamp(0.0, 1.0)
    return torch.where(
        flat, (0.5 * (a + b)).clamp_min(0.0),
        0.5 * (hi_pos + lo_pos) * torch.where(lo >= 0, 1.0, frac))


def _area_signed(d1, d2, h1, h2):
    """Signed analytic AreaTex: the implied edge line runs from height h1
    (left/up end) to h2; -> (area_this, area_other), the blend fractions
    for this pixel and for the neighbour across the edge."""
    total = d1 + d2 + 1.0
    t0 = d1 / total
    t1 = (d1 + 1.0) / total
    y0 = h1 + (h2 - h1) * t0
    y1 = h1 + (h2 - h1) * t1
    area_this = _mean_pos(y0, y1)
    area_other = _mean_pos(-y0, -y1)
    # Equal crossing heights: the silhouette is straight along the run
    # (U/bump shapes), so no blending (AreaTex zeroes those cells).
    straight = (h1 - h2).abs() < 1e-6
    return (torch.where(straight, 0.0, area_this),
            torch.where(straight, 0.0, area_other))


def diagonal_weights(e_left, e_top):
    """45-degree staircases (SMAACalculateDiagWeights): where a diagonal
    run of steps exists, boundary pixels blend 0.25 toward each crossed
    neighbour (the two end steps 0.125).  -> (a_h_diag, a_v_diag,
    is_diag)."""
    e_left_r = shift(e_left, 0, 1)
    stair1 = e_left & e_top                 # '\' steps
    stair2 = e_top & e_left_r               # '/' steps
    n1 = _run_length(stair1, 1, 1, MAX_SEARCH_DIAG) \
        + _run_length(stair1, -1, -1, MAX_SEARCH_DIAG)
    n2 = _run_length(stair2, 1, -1, MAX_SEARCH_DIAG) \
        + _run_length(stair2, -1, 1, MAX_SEARCH_DIAG)
    d1 = stair1 & (n1 >= 1)
    d2 = stair2 & (n2 >= 1)
    is_diag = d1 | d2
    n = torch.where(d1, n1, n2)
    taper = torch.where(n >= 2, 0.25, 0.125)
    a = torch.where(is_diag, taper, 0.0)
    return a, a, is_diag


def _corner_factor(edge_cross, edge_cross_deep):
    """Sharp-corner rounding: a crossing edge that continues one more
    pixel deep marks a corner; blending there scales by CORNER_ROUNDING."""
    return torch.where(edge_cross & edge_cross_deep, CORNER_ROUNDING, 1.0)


def blending_weights(e_left, e_top):
    """Pass 2 -> (a_h, a_v, a_h_above, a_v_left).  Horizontal runs (top
    edges) end at crossing LEFT edges on this row or the row above;
    symmetric for vertical runs."""
    h, w = e_left.shape
    dev = e_left.device
    xx = torch.arange(w, device=dev)[None, :].expand(h, w)
    yy = torch.arange(h, device=dev)[:, None].expand(h, w)

    e_left_up = shift(e_left, -1, 0)
    e_left_down = shift(e_left, 1, 0)
    e_left_upup = shift(e_left, -2, 0)
    d_l = _run_length(e_top, 0, -1)
    d_r = _run_length(e_top, 0, 1)
    xl = xx - d_l.long()
    xr = xx + d_r.long() + 1
    cl_here, cl_up, cl_down, cl_upup = (
        _gather_x(m, xl) for m in (e_left, e_left_up, e_left_down,
                                   e_left_upup))
    cr_here, cr_up, cr_down, cr_upup = (
        _gather_x(m, xr) for m in (e_left, e_left_up, e_left_down,
                                   e_left_upup))
    # Signed crossings: a left edge on the row ABOVE pulls the implied
    # line up (+); on THIS row pulls it down (-).
    h_l = torch.where(cl_up, 0.5, 0.0) - torch.where(cl_here, 0.5, 0.0)
    h_r = torch.where(cr_up, 0.5, 0.0) - torch.where(cr_here, 0.5, 0.0)
    a_h, a_h_above = _area_signed(d_l, d_r, h_l, h_r)
    corner = _corner_factor(cl_here | cl_up,
                            (cl_here & cl_down) | (cl_up & cl_upup)) \
        * _corner_factor(cr_here | cr_up,
                         (cr_here & cr_down) | (cr_up & cr_upup))
    a_h = torch.where(e_top, a_h * corner, 0.0)
    a_h_above = torch.where(e_top, a_h_above * corner, 0.0)

    e_top_left = shift(e_top, 0, -1)
    e_top_right = shift(e_top, 0, 1)
    e_top_leftleft = shift(e_top, 0, -2)
    d_u = _run_length(e_left, -1, 0)
    d_d = _run_length(e_left, 1, 0)
    yu = yy - d_u.long()
    yd = yy + d_d.long() + 1
    cu_here, cu_left, cu_right, cu_ll = (
        _gather_y(m, yu) for m in (e_top, e_top_left, e_top_right,
                                   e_top_leftleft))
    cd_here, cd_left, cd_right, cd_ll = (
        _gather_y(m, yd) for m in (e_top, e_top_left, e_top_right,
                                   e_top_leftleft))
    h_u = torch.where(cu_left, 0.5, 0.0) - torch.where(cu_here, 0.5, 0.0)
    h_d = torch.where(cd_left, 0.5, 0.0) - torch.where(cd_here, 0.5, 0.0)
    a_v, a_v_left = _area_signed(d_u, d_d, h_u, h_d)
    cornerv = _corner_factor(cu_here | cu_left,
                             (cu_here & cu_right) | (cu_left & cu_ll)) \
        * _corner_factor(cd_here | cd_left,
                         (cd_here & cd_right) | (cd_left & cd_ll))
    a_v = torch.where(e_left, a_v * cornerv, 0.0)
    a_v_left = torch.where(e_left, a_v_left * cornerv, 0.0)

    # Diagonal patterns override the orthogonal weights where detected.
    ah_d, av_d, is_diag = diagonal_weights(e_left, e_top)
    return (torch.where(is_diag, ah_d, a_h), torch.where(is_diag, av_d, a_v),
            torch.where(is_diag, ah_d, a_h_above),
            torch.where(is_diag, av_d, a_v_left))


def neighborhood_blend(rgb, a_h, a_v, a_h_above, a_v_left):
    """Pass 3: a_h mixes the ABOVE colour into this pixel; a_h_above
    (stored at the edge pixel) mixes THIS colour into the pixel above,
    delivered here from the pixel below's edge.  Symmetric for vertical
    edges."""
    out = rgb
    out = out + a_h[..., None] * (shift(rgb, -1, 0) - out)
    out = out + a_v[..., None] * (shift(rgb, 0, -1) - out)
    a_from_below = shift(a_h_above, 1, 0)
    a_from_right = shift(a_v_left, 0, 1)
    out = out + a_from_below[..., None] * (shift(rgb, 1, 0) - out)
    out = out + a_from_right[..., None] * (shift(rgb, 0, 1) - out)
    return out


def smaa(rgb):
    """Full SMAA 1x chain on tonemapped LDR (H, W, 3)."""
    e_left, e_top = edge_detection(rgb)
    return neighborhood_blend(rgb, *blending_weights(e_left, e_top)) \
        .clamp(0.0, 1.0)
