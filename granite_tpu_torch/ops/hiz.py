"""Hierarchical-Z pyramid + occlusion culling (port of
granite_tpu/ops/hiz.py; reference post/hiz.comp and the two-phase GPU
occlusion culler, renderer/scene_renderer.hpp:132, meshlet_cull.comp).

Reverse-Z: depth 1 = near, 0 = far/background.  Each level stores the
MIN depth (the farthest point) of its footprint, so an object is visible
when its nearest depth (max z) >= the min over its screen rect at the
level where the rect spans <= 2x2 texels.  The viewer runs the two
phases (app/scene_viewer.py, occlusionCulling).  Plain PyTorch: the
reference is jnp, not a Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .texture import saturating_int32


def build_hiz(depth: torch.Tensor, levels: int | None = None) -> list:
    """Min-depth pyramid [(H, W), (H/2, W/2), ...], built while the
    smaller side is > 1.  Odd sizes pad with the edge (conservative)."""
    out = [depth]
    cur = depth
    n = levels or 32
    while len(out) < n and min(cur.shape) > 1:
        h, w = cur.shape
        ph, pw = h % 2, w % 2
        if ph or pw:
            cur = F.pad(cur[None, None], (0, pw, 0, ph),
                        mode="replicate")[0, 0]
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        cur = cur.reshape(h2, 2, w2, 2).amin(dim=(1, 3))
        out.append(cur)
    return out


def _texel(c, scale: float, size: int):
    """Pixel coordinate -> texel index at a level, truncated toward zero
    and saturated like XLA's cast (project_aabbs' coordinates reach ~1e9
    and beyond near the camera plane), then clipped to the level."""
    return saturating_int32(c / scale).clamp(0, size - 1).long()


def occlusion_test(hiz: list, rect_min, rect_max, max_z, width: int,
                   height: int):
    """Conservative visibility of screen rects against the pyramid.

    rect_min / rect_max: (N, 2) pixel coords; max_z: (N,) nearest depth
    (reverse-Z).  -> (N,) bool visible.  Each rect is tested at the
    smallest level where it spans <= 2 texels: 4 gathers cover it."""
    span = (rect_max - rect_min).clamp_min(0.0)
    max_span = torch.maximum(span[:, 0], span[:, 1])
    level = saturating_int32(torch.ceil(torch.log2(
        max_span.clamp_min(1.0))).clamp(0, len(hiz) - 1))
    visible = torch.zeros(rect_min.shape[0], dtype=torch.bool,
                          device=rect_min.device)
    evaluated = torch.zeros_like(visible)
    for lv, tex in enumerate(hiz):
        sel = level == lv
        scale = float(1 << lv)
        h, w = tex.shape
        x0 = _texel(rect_min[:, 0], scale, w)
        y0 = _texel(rect_min[:, 1], scale, h)
        x1 = _texel(rect_max[:, 0], scale, w)
        y1 = _texel(rect_max[:, 1], scale, h)
        m = torch.minimum(torch.minimum(tex[y0, x0], tex[y0, x1]),
                          torch.minimum(tex[y1, x0], tex[y1, x1]))
        # >=: a rect over background (0) stays visible.
        vis_lv = max_z >= m
        visible = torch.where(sel & ~evaluated, vis_lv, visible)
        evaluated = evaluated | sel
    return visible | ~evaluated


_CORNERS = [[(i >> k) & 1 for k in range(3)] for i in range(8)]


def project_aabbs(world_min, world_max, view_proj, width: int,
                  height: int):
    """World AABBs (N, 3) -> (rect_min (N, 2), rect_max (N, 2), max_z
    (N,), behind (N,)): conservative screen rects and nearest depth.
    Objects with a corner behind the near plane (w <= 1e-6) are flagged
    `behind` (the caller keeps them visible, as the reference's cull
    shader does)."""
    corners = torch.tensor(_CORNERS, dtype=torch.float32,
                           device=world_min.device)
    pts = world_min[:, None, :] * (1 - corners[None]) \
        + world_max[:, None, :] * corners[None]               # (N, 8, 3)
    hcl = pts @ view_proj[:3, :3].T + view_proj[:3, 3]
    wcl = pts @ view_proj[3, :3] + view_proj[3, 3]
    behind = (wcl <= 1e-6).any(dim=1)
    w_safe = torch.where(wcl.abs() < 1e-6, torch.full_like(wcl, 1e-6), wcl)
    sx = (0.5 * hcl[..., 0] / w_safe + 0.5) * width
    sy = (0.5 * hcl[..., 1] / w_safe + 0.5) * height
    z = hcl[..., 2] / w_safe
    rect_min = torch.stack([sx.amin(1), sy.amin(1)], -1)
    rect_max = torch.stack([sx.amax(1), sy.amax(1)], -1)
    max_z = z.amax(1).clamp(0.0, 1.0)
    return rect_min, rect_max, max_z, behind
