"""Directional shadow mapping (port of the PCF path of
granite_tpu/ops/shadow.py; reference assets/shaders/lights/pcf.h).

Shadow maps are reverse-Z like the main view; a receiver is lit when its
light-space depth >= occluder depth - bias.  The slice implements the
default hardware-style 2x2 PCF; wide PCF, VSM and cascades are not part
of it (the viewer raises for those knobs).
"""

from __future__ import annotations

import numpy as np
import torch

from granite_tpu.math.muglm import look_at_matrix, ortho

from .texture import quad_pack2d


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
    x0 = torch.floor(x).to(torch.int32).clamp(0, w - 1)
    y0 = torch.floor(y).to(torch.int32).clamp(0, h - 1)
    fx = (x - x0.to(x.dtype)).clamp(0.0, 1.0)
    fy = (y - y0.to(y.dtype)).clamp(0.0, 1.0)
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
