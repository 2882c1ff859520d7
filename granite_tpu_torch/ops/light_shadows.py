"""Clustered point/spot light shadows — the shadow-atlas path (port of
granite_tpu/ops/light_shadows.py; reference renderer/lights/clusterer.hpp
PCF atlas).

Every shadowed light owns 1 (spot) or 6 (point) atlas slices rendered
once with kernel B1 and cached; the atlas is quad-packed and flattened
so one fetch returns a slice texel's 2x2 compare footprint.  Shading
picks, per pixel, the first K cluster-active shadowed lights and fetches
K terms, whatever the light count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math.muglm import look_at_matrix, perspective
from ..utils.timeline_trace import upload
from .hdr import clamped_floor
from .shadow import _vsm_term, vsm_moments
from .texture import quad_pack2d

FACE_DIRS = np.array([
    [1, 0, 0], [-1, 0, 0],
    [0, 1, 0], [0, -1, 0],
    [0, 0, 1], [0, 0, -1]], np.float32)
FACE_UPS = np.array([
    [0, 1, 0], [0, 1, 0],
    [0, 0, 1], [0, 0, -1],
    [0, 1, 0], [0, 1, 0]], np.float32)


def spot_shadow_matrix(pos, direction, outer_cone: float,
                       radius: float) -> np.ndarray:
    pos = np.asarray(pos, np.float32)
    d = np.asarray(direction, np.float32)
    d = d / max(np.linalg.norm(d), 1e-9)
    up = np.array([0, 1, 0], np.float32)
    if abs(float(d @ up)) > 0.99:
        up = np.array([0, 0, 1], np.float32)
    view = look_at_matrix(pos, pos + d, up)
    fov = min(max(2.0 * float(outer_cone), 0.1), 3.0)
    near = max(0.005 * radius, 1e-3)
    proj = perspective(fov, 1.0, near, radius)
    return (proj @ view).astype(np.float32)


def point_face_matrices(pos, radius: float) -> np.ndarray:
    pos = np.asarray(pos, np.float32)
    near = max(0.005 * radius, 1e-3)
    proj = perspective(np.pi / 2, 1.0, near, radius)
    mats = []
    for f in range(6):
        view = look_at_matrix(pos, pos + FACE_DIRS[f], FACE_UPS[f])
        mats.append((proj @ view).astype(np.float32))
    return np.stack(mats)


def assign_slices(light_infos):
    """light_infos: dicts {pos, dir, radius, outer, is_spot} ->
    (vps (NS, 4, 4), light_slice (L,) first slice, light_kind (L,)
    0 spot / 1 point)."""
    vps, slices, kinds = [], [], []
    for li in light_infos:
        slices.append(len(vps))
        if li["is_spot"]:
            kinds.append(0)
            vps.append(spot_shadow_matrix(li["pos"], li["dir"],
                                          li["outer"], li["radius"]))
        else:
            kinds.append(1)
            vps.extend(point_face_matrices(li["pos"], li["radius"]))
    if not vps:
        vps = [np.eye(4, dtype=np.float32)]
    return (np.stack(vps).astype(np.float32),
            np.asarray(slices, np.int32), np.asarray(kinds, np.int32))


def pack_atlas(slices: torch.Tensor) -> torch.Tensor:
    """(NS, S, S) depth slices -> (NS*S*S, 4) quad-packed flat atlas."""
    NS, S, _ = slices.shape
    packed = torch.stack([quad_pack2d(s[..., None]) for s in slices])
    return packed.reshape(NS * S * S, 4)


def pack_atlas_vsm(slices: torch.Tensor) -> torch.Tensor:
    """clusteredLightsShadowsVSM (clusterer.hpp ShadowType::VSM): (NS, S,
    S) depth slices -> each slice's blurred moments, quad-packed to
    (NS*S*S, 8), lanes [m1 m2] x [t00 t10 t01 t11]."""
    NS, S, _ = slices.shape
    packed = torch.stack([quad_pack2d(vsm_moments(s)) for s in slices])
    return packed.reshape(NS * S * S, 8)


def _clip_coords(x, y, S: int):
    """Start texel clipped to [0, S-1] + clamped fracs; clamping in float
    first equals XLA's saturating cast followed by the clip."""
    x0 = clamped_floor(x, S - 1)
    y0 = clamped_floor(y, S - 1)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    return x0.to(torch.int32), y0.to(torch.int32), fx, fy


def _light_sample_coords(world_pos, vps_np, slice0: int, kind: int,
                         light_pos_np, size: int):
    """Per-pixel flat atlas index + compare data for one light with
    host-known matrices -> (flat, z, fx, fy, inside)."""
    S = size
    dev = world_pos.device
    if kind == 1:
        # Closed-form cube-face projection: each face view is an axis
        # permutation/sign of d = p - light_pos sharing one projection.
        d = world_pos - upload(np.array(light_pos_np, np.float32),
                               device=dev)
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        ax, ay, az = dx.abs(), dy.abs(), dz.abs()
        face = torch.where(
            (ax >= ay) & (ax >= az), torch.where(dx >= 0, 0, 1),
            torch.where(ay >= az, torch.where(dy >= 0, 2, 3),
                        torch.where(dz >= 0, 4, 5)))
        is_x = face < 2
        is_y = (face == 2) | (face == 3)
        neg = (face & 1) == 1
        x_c = torch.where(is_x, torch.where(neg, -dz, dz),
                          torch.where(face == 4, -dx, dx))
        y_c = torch.where(is_y, torch.where(neg, -dz, dz), dy)
        w = torch.maximum(torch.maximum(ax, ay), az.clamp_min(1e-9))
        row = np.asarray(vps_np[slice0])[2]
        m22 = float(np.linalg.norm(row[:3]))
        m23 = float(row[3] + row[:3]
                    @ np.asarray(light_pos_np, np.float32))
        inv_w = 1.0 / w
        u = 0.5 * x_c * inv_w + 0.5
        v = -0.5 * y_c * inv_w + 0.5
        z = -m22 + m23 * inv_w
        slice_id = slice0 + face
    else:
        m = upload(np.array(vps_np[slice0]), device=dev)
        xyzw = world_pos @ m[:, :3].T + m[:, 3]
        w = xyzw[..., 3].clamp_min(1e-9)
        u = 0.5 * xyzw[..., 0] / w + 0.5
        v = 0.5 * xyzw[..., 1] / w + 0.5
        z = xyzw[..., 2] / w
        slice_id = slice0
    x0, y0, fx, fy = _clip_coords(u * S - 0.5, v * S - 0.5, S)
    flat = (slice_id * S + y0) * S + x0
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (z >= 0.0) \
        & (z <= 1.0)
    return flat, z, fx, fy, inside


def topk_shadow_terms(atlas_flat, vps_np, size: int, num_lights: int,
                      light_slice_np, light_kind_np, light_pos_np,
                      pixel_masks, world_pos, k: int = 4,
                      bias: float = 2e-3):
    """Per-pixel terms of the first K cluster-active shadowed lights: the
    2x2 PCF compare, or on an (NS*S*S, 8) moment atlas the bilinear
    moments' Chebyshev bound (vsm.h).  pixel_masks (..., 1) int32.  ->
    (slot_light (K, ...) int32, -1 = empty; terms (K, ...) f32)."""
    shape = world_pos.shape[:-1]
    dev = world_pos.device
    slot_light = [torch.full(shape, -1, dtype=torch.int32, device=dev)
                  for _ in range(k)]
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    slot_flat = [torch.zeros(shape, dtype=torch.int64, device=dev)
                 for _ in range(k)]
    slot_z = [zero] * k
    slot_fx = [zero] * k
    slot_fy = [zero] * k
    slot_in = [torch.zeros(shape, dtype=torch.bool, device=dev)] * k
    taken = torch.zeros(shape, dtype=torch.int32, device=dev)
    for i in range(num_lights):
        if light_slice_np[i] < 0:
            continue
        bit = (1 << i) if i < 31 else -(1 << 31)
        active = (pixel_masks[..., i // 32] & bit) != 0
        flat, z, fx, fy, inside = _light_sample_coords(
            world_pos, vps_np, int(light_slice_np[i]),
            int(light_kind_np[i]), light_pos_np[i], size)
        for s in range(k):
            place = active & (taken == s)
            slot_light[s] = torch.where(place, i, slot_light[s])
            slot_flat[s] = torch.where(place, flat.long(), slot_flat[s])
            slot_z[s] = torch.where(place, z, slot_z[s])
            slot_fx[s] = torch.where(place, fx, slot_fx[s])
            slot_fy[s] = torch.where(place, fy, slot_fy[s])
            slot_in[s] = torch.where(place, inside, slot_in[s])
        taken = taken + active.to(torch.int32)
    vsm = atlas_flat.shape[-1] == 8
    terms = []
    for s in range(k):
        quad = atlas_flat[slot_flat[s]]
        fx, fy = slot_fx[s], slot_fy[s]
        if vsm:
            q = quad.reshape(quad.shape[:-1] + (4, 2))
            fx2, fy2 = fx[..., None], fy[..., None]
            top = q[..., 0, :] * (1 - fx2) + q[..., 1, :] * fx2
            bot = q[..., 2, :] * (1 - fx2) + q[..., 3, :] * fx2
            mm = top * (1 - fy2) + bot * fy2
            term = _vsm_term(slot_z[s], mm[..., 0], mm[..., 1])
        else:
            c = (slot_z[s][..., None] >= quad - bias).to(torch.float32)
            top = c[..., 0] * (1 - fx) + c[..., 1] * fx
            bot = c[..., 2] * (1 - fx) + c[..., 3] * fx
            term = top * (1 - fy) + bot * fy
        term = torch.where(slot_in[s], term, torch.ones_like(term))
        terms.append(torch.where(slot_light[s] >= 0, term,
                                 torch.ones_like(term)))
    return torch.stack(slot_light), torch.stack(terms)
