"""Directional shadow mapping (port of the PCF and VSM paths of
granite_tpu/ops/shadow.py; reference assets/shaders/lights/pcf.h, vsm.h).

Shadow maps are reverse-Z like the main view; a receiver is lit when its
light-space depth >= occluder depth - bias.  The port implements the
default hardware-style 2x2 PCF and variance shadow maps (moments blurred
once, Chebyshev bound with the light-leak clamp), the 6x6 windowed PCF
kernel (pcf.h SHADOW_MAP_PCF_KERNEL_WIDE) and four camera-fitted
cascades with the reference's 10% cross-fade band.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math.muglm import look_at_matrix, ortho
from .hdr import _sample_bilinear_uv, clamped_floor, resize_bilinear
from .texture import INT32_MIN, quad_pack2d, saturating_int32
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


def _pcf_kernel_weight(x):
    """pcf.h shadow_map_pcf_kernel: exp2(-0.375 x^2) * (1 - x^2 / 9)."""
    x2 = x * x
    return torch.exp2(-0.375 * x2) * (1.0 - x2 / 9.0)


def _add_int32(x, d: int):
    """x + d on int32 with XLA's two's-complement wrap (a saturated
    INT32_MAX + 2 comes out negative and clips to texel 0)."""
    y = x.to(torch.int64) + d
    return (torch.remainder(y - INT32_MIN, 2 ** 32) + INT32_MIN) \
        .to(torch.int32)


def pcf_wide(shadow_map, u, v, ref_z, bias: float = 1e-3):
    """6x6 windowed PCF (SHADOW_MAP_PCF_KERNEL_WIDE, pcf.h:10-74): nine
    quad fetches at even offsets cover the 6x6 tap window, each weighted
    by the reference's window; border blocks clamp the whole 2x2, as in
    the reference.  The start texel is cast as XLA casts (saturating) and
    offset in wrapping int32 before the clip."""
    h, w = shadow_map.shape[:2]
    packed = quad_pack2d(shadow_map[..., None])      # (H, W, 4)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = saturating_int32(x0)
    y0i = saturating_int32(y0)
    acc = 0.0
    total_w = 0.0
    for by in (-2, 0, 2):
        yb = _add_int32(y0i, by).clamp(0, h - 1).long()
        for bx in (-2, 0, 2):
            xb = _add_int32(x0i, bx).clamp(0, w - 1).long()
            quad = packed[yb, xb]                    # (..., 4)
            c = (ref_z[..., None] >= quad - bias).to(torch.float32)
            for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0),
                                          (1, 1))):
                wgt = (_pcf_kernel_weight(by + dy - fy)
                       * _pcf_kernel_weight(bx + dx - fx))
                acc = acc + wgt * c[..., k]
                total_w = total_w + wgt
    term = acc / total_w
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (ref_z <= 1.0)
    return torch.where(inside, term, torch.ones_like(term))


def sample_directional_shadow(shadow_map, shadow_uv_mat, world_pos,
                              wide: bool = False, bias: float = 1e-3):
    """Project world positions into the shadow map and PCF (the 6x6
    windowed kernel when wide)."""
    m = shadow_uv_mat
    uvw = world_pos @ m[:3, :3].T + m[:3, 3]
    pcf = pcf_wide if wide else pcf_2x2
    return pcf(shadow_map, uvw[..., 0], uvw[..., 1], uvw[..., 2], bias)


# ---------------------------------------------------------------------------
# Cascaded shadow maps (SHADOW_NUM_CASCADES = 4, directional.frag:8).
# ---------------------------------------------------------------------------

def cascade_matrices(light_dir, camera_pos, camera_front, scene_min,
                     scene_max, num_cascades: int = 4,
                     first_radius: float = 8.0,
                     up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """(C, 4, 4) light view-projs: cascade c an ortho frustum of radius
    first_radius * 2^c centred half a radius ahead of the camera, its
    depth range reaching past the scene bounds (the reference's log
    split)."""
    light_dir = np.asarray(light_dir, np.float32)
    light_dir = light_dir / np.linalg.norm(light_dir)
    camera_pos = np.asarray(camera_pos, np.float32)
    camera_front = np.asarray(camera_front, np.float32)
    scene_r = 0.5 * float(np.linalg.norm(
        np.asarray(scene_max) - np.asarray(scene_min)))
    if abs(np.dot(light_dir, np.asarray(up, np.float32))) > 0.99:
        up = (0.0, 0.0, 1.0)
    mats = []
    for c in range(num_cascades):
        radius = first_radius * (2.0 ** c)
        center = camera_pos + camera_front * (0.5 * radius)
        eye = center + light_dir * (scene_r + radius)
        view = look_at_matrix(eye, center, up)
        proj = ortho(-radius, radius, -radius, radius,
                     0.5 * radius, 2.0 * (scene_r + radius))
        mats.append((proj @ view).astype(np.float32))
    return np.stack(mats)


def sample_cascaded_shadow(shadow_maps, cascade_uv_mats, world_pos,
                           wide: bool = False, bias: float = 1e-3):
    """Cascade selection + PCF + cross-fade (compute_shadow_cascade):
    shadow_maps (C, S, S), cascade_uv_mats (C, 4, 4) world -> uvz.  The
    terms blend far to near, each cascade weighted by how deep inside its
    UV footprint the point lies (a 10% fade band), so nearer cascades
    override."""
    terms, margins = [], []
    for c in range(shadow_maps.shape[0]):
        m = cascade_uv_mats[c]
        uvw = world_pos @ m[:3, :3].T + m[:3, 3]
        u, v, z = uvw[..., 0], uvw[..., 1], uvw[..., 2]
        pcf = pcf_wide if wide else pcf_2x2
        terms.append(pcf(shadow_maps[c], u, v, z, bias))
        margins.append(torch.maximum(
            (u - 0.5).abs(), (v - 0.5).abs()).mul(2.0).clamp_min(0.0))
    term = torch.ones_like(terms[0])
    for c in reversed(range(len(terms))):
        w = ((1.0 - margins[c]) / 0.1).clamp(0.0, 1.0)
        term = term + (terms[c] - term) * w
    return term


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
