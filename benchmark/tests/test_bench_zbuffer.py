"""The reference's z-buffer against the definition it implements: a pixel
shows the nearest triangle whose plane the pixel's ray meets inside the
triangle, in front of the near plane (0 < z_ndc <= 1), solved per pixel
and triangle in float64.  The triangles straddle the camera: many cross
the near plane, some with a vertex all but on the camera's plane
(w ~ 0), where a setup without clipping can claim pixels the triangle
does not cover."""

import numpy as np
import torch

from plainref.scene import perspective
from plainref.zbuffer import orientation, rasterize

W, H = 64, 48


def brute_force(clip, cull_back):
    """-> (depth (H, W), any_near_edge (H, W)) by the definition."""
    px = (torch.arange(W, dtype=torch.float64) + 0.5) * 2 / W - 1
    py = (torch.arange(H, dtype=torch.float64) + 0.5) * 2 / H - 1
    ndc = torch.stack(torch.broadcast_tensors(
        px[None, :], py[:, None], torch.ones(1, 1, dtype=torch.float64)), -1)
    m = clip[..., [0, 1, 3]].transpose(1, 2)             # (T, 3, 3)
    c = torch.einsum("tij,hwj->thwi", torch.linalg.inv(m), ndc)
    s = c.sum(-1)
    b = c / s[..., None]
    inside = (b >= 0).all(-1) & (s > 0)
    z = (b * clip[:, None, None, :, 2]).sum(-1) / (1 / s)
    ok = inside & (z > 0) & (z <= 1)
    if cull_back:
        ok &= (orientation(clip) < 0)[:, None, None]
    zz = torch.where(ok, z, torch.zeros_like(z))
    edge = ((b.abs().amin(-1) < 1e-4) & (s > 0)).any(0) \
        | ((z - 1).abs() < 1e-6).any(0)
    return zz.amax(0), edge


def scene(seed):
    rng = np.random.default_rng(seed)
    n = 60
    centre = rng.uniform([-3, -2, -6], [3, 2, 1.5], (n, 1, 3))
    verts = centre + rng.normal(0, 1.5, (n, 3, 3))
    # a few with one vertex all but on the camera's plane (z_view ~ 0)
    verts[:8, 0, 2] = rng.uniform(-1e-5, 1e-5, 8)
    proj = perspective(1.0, W / H, 0.05)
    hom = np.concatenate([verts, np.ones((n, 3, 1))], -1)
    clip = torch.as_tensor(hom @ proj.T)
    return clip, torch.arange(3 * n).reshape(n, 3)


def test_zbuffer_matches_the_definition():
    for seed in range(6):
        clip, vid = scene(seed)
        for cull in (False, True):
            depth, tri = rasterize(clip, vid, W, H, cull_back=cull)
            want, edge = brute_force(clip, cull)
            assert bool(((want > 0) & (want < 1)).any())
            off = ((depth.double() > 0) != (want > 0)) \
                | ((depth.double() - want).abs() > 1e-5)
            assert not bool((off & ~edge).any()), (seed, cull,
                                                   int((off & ~edge).sum()))
            # the crossers of the near plane are drawn where they cover
            assert (tri >= 0).sum() > 0.3 * W * H
