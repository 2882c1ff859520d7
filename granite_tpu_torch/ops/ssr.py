"""Screen-space reflections (port of granite_tpu/ops/ssr.py; reference
renderer/post/ssr.cpp, the `ssr` knob; deferred only).

A half-resolution mirror-direction ray march in view space: STEPS linear
probes against the half-res depth, the first hit's colour fetched
bilinearly, faded by the screen edge, roughness and rays toward the
camera, Fresnel-weighted, upsampled and added to the lit frame.  Plain
PyTorch: the reference is jnp, not a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .hdr import _sample_bilinear_uv, resize_bilinear, uv_grid
from .pbr import compute_f0

STEPS = 8
MAX_DISTANCE = 20.0     # view-space length of the marched ray


def view_positions(depth, inv_proj, width: int, height: int):
    """View-space positions (H, W, 3) from reverse-Z depth through the
    (4, 4) inverse projection."""
    uu, vv = uv_grid(height, width, depth.device)
    ndc = torch.stack([2 * uu - 1, 2 * vv - 1, depth, torch.ones_like(uu)],
                      dim=-1)
    vp = ndc @ inv_proj.T
    w = vp[..., 3:4]
    return vp[..., :3] / torch.where(w.abs() < 1e-12,
                                     torch.full_like(w, 1e-12), w)


def _pixel_index(s, n: int):
    """The reference's clip(int(s), 0, n - 1), clamped as a float first:
    a torch cast sends NaN and out-of-range values to INT_MIN where XLA
    saturates (those samples are masked anyway)."""
    return torch.nan_to_num(s, nan=0.0).clamp(0, n - 1).trunc().long()


def ssr(hdr, depth, normal_world, base_color, metallic, roughness,
        view, proj, width: int, height: int):
    """-> (H, W, 3) HDR with reflections added.

    hdr: the lit opaque frame; depth: (H, W) reverse-Z; normal_world:
    (H, W, 3); view: (4, 4) world -> view tensor; proj: the host (4, 4)
    projection (inverted on the host in float32)."""
    dev = hdr.device
    H2, W2 = height // 2, width // 2
    d_half = depth[::2, ::2]
    n_half = normal_world[::2, ::2]
    proj = np.asarray(proj, np.float32)
    inv_proj = torch.as_tensor(np.linalg.inv(proj), device=dev)
    p3, pt = (torch.as_tensor(proj[:3, :3], device=dev),
              torch.as_tensor(proj[:3, 3], device=dev))
    pw, pw3 = torch.as_tensor(proj[3, :3], device=dev), float(proj[3, 3])

    vpos = view_positions(d_half, inv_proj, W2, H2)
    nv = n_half @ view[:3, :3].T
    vdir = vpos / torch.sqrt((vpos * vpos).sum(-1, keepdim=True)
                             .clamp_min(1e-12))
    rdir = vdir - 2.0 * (vdir * nv).sum(-1, keepdim=True) * nv

    covered = d_half > 0.0
    hit = torch.zeros(d_half.shape, dtype=torch.bool, device=dev)
    hit_uv = torch.zeros(d_half.shape + (2,), dtype=torch.float32,
                         device=dev)
    t_step = MAX_DISTANCE / STEPS
    eps = 0.02
    for s in range(1, STEPS + 1):
        p = vpos + rdir * (s * t_step)
        clip = p @ p3.T + pt
        w = p @ pw + pw3
        valid = w > 1e-4
        w_safe = torch.where(valid, w, torch.ones_like(w))
        sx = 0.5 * clip[..., 0] / w_safe + 0.5
        sy = 0.5 * clip[..., 1] / w_safe + 0.5
        rz = clip[..., 2] / w_safe                    # the ray's NDC depth
        scene_z = d_half[_pixel_index(sy * H2, H2), _pixel_index(sx * W2, W2)]
        on = valid & (sx >= 0) & (sx < 1) & (sy >= 0) & (sy < 1)
        # Reverse-Z: the scene is closer than the ray -> it went behind.
        behind = scene_z > rz + eps * rz
        new_hit = covered & on & behind & ~hit & (scene_z > 0)
        hit_uv = torch.where(new_hit[..., None], torch.stack([sx, sy], -1),
                             hit_uv)
        hit = hit | new_hit

    refl = _sample_bilinear_uv(hdr[::2, ::2], hit_uv[..., 0], hit_uv[..., 1])
    edge = (1.0 - (hit_uv[..., 0] * 2 - 1).abs() ** 4) * \
        (1.0 - (hit_uv[..., 1] * 2 - 1).abs() ** 4)
    rough_fade = (1.0 - roughness[::2, ::2] * 1.5).clamp(0.0, 1.0)
    toward = (-rdir[..., 2] * 4.0 + 1.0).clamp(0.0, 1.0)
    amount = hit.to(torch.float32) * edge * rough_fade * toward

    f0 = compute_f0(base_color[::2, ::2], metallic[::2, ::2][..., None])
    nov = (-vdir * nv).sum(-1).clamp(0.0, 1.0)
    fres = f0 + (1.0 - f0) * ((1.0 - nov) ** 5)[..., None]
    add_half = refl * fres * amount[..., None]
    return hdr + resize_bilinear(add_half, height, width)
