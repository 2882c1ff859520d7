"""Directional shadow mapping (port of the PCF and VSM paths of
granite_tpu/ops/shadow.py; reference assets/shaders/lights/pcf.h, vsm.h).

Shadow maps are reverse-Z like the main view; a receiver is lit when its
light-space depth >= occluder depth - bias.  The port implements the
default hardware-style 2x2 PCF and variance shadow maps (moments blurred
once, Chebyshev bound with the light-leak clamp); wide PCF and cascades
are not part of it (the viewer raises for those knobs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..math.muglm import look_at_matrix, ortho
from .hdr import _sample_bilinear_uv, clamped_floor, resize_bilinear
from .texture import quad_pack2d
from .tile_sampler import sample_bilinear


def directional_shadow_matrix(light_dir, scene_min, scene_max,
                              up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Ortho reverse-Z light view-proj fitted around the scene AABB."""
    light_dir = np.asarray(light_dir, np.float32)
    light_dir = light_dir / np.linalg.norm(light_dir)
    center = 0.5 * (np.asarray(scene_min) + np.asarray(scene_max))
    radius = 0.5 * float(np.linalg.norm(
        np.asarray(scene_max) - np.asarray(scene_min)))
    if abs(np.dot(light_dir, np.asarray(up, np.float32))) > 0.99:
        up = (0.0, 0.0, 1.0)
    eye = center + light_dir * radius * 1.5
    view = look_at_matrix(eye, center, up)
    proj = ortho(-radius, radius, -radius, radius, 0.5 * radius,
                 2.5 * radius)
    return (proj @ view).astype(np.float32)


def shadow_uv_transform(light_vp: np.ndarray) -> np.ndarray:
    """World -> shadow-map texture space (uv = xy*0.5+0.5, z depth)."""
    remap = np.array([[0.5, 0, 0, 0.5],
                      [0, 0.5, 0, 0.5],
                      [0, 0, 1.0, 0.0],
                      [0, 0, 0, 1.0]], np.float32)
    return (remap @ light_vp).astype(np.float32)


def pcf_2x2(shadow_map, u, v, ref_z, bias: float = 1e-3):
    """Bilinear 2x2 percentage-closer compare (pcf.h textureProjLod);
    outside the light frustum is fully lit."""
    h, w = shadow_map.shape[:2]
    packed = quad_pack2d(shadow_map[..., None])      # (H, W, 4)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = clamped_floor(x, w - 1)
    y0 = clamped_floor(y, h - 1)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    c = (ref_z[..., None] >= packed[y0.long(), x0.long()] - bias) \
        .to(torch.float32)
    top = c[..., 0] * (1 - fx) + c[..., 1] * fx
    bot = c[..., 2] * (1 - fx) + c[..., 3] * fx
    term = top * (1 - fy) + bot * fy
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (ref_z <= 1.0)
    return torch.where(inside, term, torch.ones_like(term))


def sample_directional_shadow(shadow_map, shadow_uv_mat, world_pos,
                              bias: float = 1e-3):
    """Project world positions into the shadow map and PCF."""
    m = shadow_uv_mat
    uvw = world_pos @ m[:3, :3].T + m[:3, 3]
    return pcf_2x2(shadow_map, uvw[..., 0], uvw[..., 1], uvw[..., 2], bias)


# ---------------------------------------------------------------------------
# Variance shadow maps.  The maps are reverse-Z (larger = closer to the
# light), so a receiver is potentially occluded when its depth is SMALLER
# than the mean.  Moments stay f32 end to end: m2 - m1^2 cancels.
# ---------------------------------------------------------------------------

_BINOMIAL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def vsm_moments(depth):
    """(S, S) depth -> (S, S, 2) contiguous moments (z, z^2), blurred by
    the 5-tap binomial with edge clamp along each axis (the VSM resolve +
    blur).  Contiguous because kernel B3T reads them as a flat map."""
    m = torch.stack([depth, depth * depth], dim=-1)

    def blur_axis(x, axis):
        x = x.movedim(axis, 0)
        n = x.shape[0]
        pad = torch.cat([x[:1], x[:1], x, x[-1:], x[-1:]])
        out = sum(k * pad[j:j + n] for j, k in enumerate(_BINOMIAL5))
        return out.movedim(0, axis)

    return blur_axis(blur_axis(m, 0), 1).contiguous()


def _vsm_term(depth, m1, m2):
    """Chebyshev upper bound with the light-leak clamp (vsm.h)."""
    variance = (m2 - m1 * m1).clamp_min(1e-5)
    d = m1 - depth
    term = variance / (variance + d * d)
    term = ((term - 0.25) / 0.75).clamp(0.0, 1.0)
    return torch.where(depth < m1, term, torch.ones_like(term))


def light_uvz(shadow_uv_mat, world_pos):
    """World positions -> (u, v, z, inside the light frustum)."""
    m = shadow_uv_mat
    uvw = world_pos @ m[:3, :3].T + m[:3, 3]
    u, v, z = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (z <= 1.0)
    return u, v, z, inside


def sample_vsm_shadow(moments, shadow_uv_mat, world_pos):
    """Directional VSM term: bilinear moment fetch + Chebyshev, per pixel
    (the reference's classic route)."""
    u, v, z, inside = light_uvz(shadow_uv_mat, world_pos)
    mm = _sample_bilinear_uv(moments, u, v)
    term = _vsm_term(z, mm[..., 0], mm[..., 1])
    return torch.where(inside, term, torch.ones_like(term))


def sample_vsm_shadow_tiled(moments, shadow_uv_mat, world_pos, covered):
    """Directional VSM through kernel B3T (the reference's tile-sampler
    route, sample_vsm_shadow_tiled).

    The moment fetch is an exact clamp-to-edge bilinear of the level-0
    moments; pixels that are uncovered or outside the light frustum skip
    it (moments 0).  As in the reference, the fetch and the Chebyshev
    term run at half resolution when the frame is even-sized and >= 64
    rows, and the term is bilinearly upsampled; outside the frustum the
    term is 1.  The reference's rect planner may sample a coarser moment
    mip where a tile's footprint is tall; the port always samples level 0
    (ROADMAP queue C)."""
    u, v, z, inside = light_uvz(shadow_uv_mat, world_pos)
    live = covered & inside
    H, W = u.shape
    if H % 2 == 0 and W % 2 == 0 and H >= 64:
        zh = z[::2, ::2]
        mm = sample_bilinear(moments, u[::2, ::2], v[::2, ::2],
                             live[::2, ::2])
        term_h = _vsm_term(zh, mm[..., 0], mm[..., 1])
        term = resize_bilinear(term_h[..., None], H, W)[..., 0]
    else:
        mm = sample_bilinear(moments, u, v, live)
        term = _vsm_term(z, mm[..., 0], mm[..., 1])
    return torch.where(inside, term, torch.ones_like(term))
