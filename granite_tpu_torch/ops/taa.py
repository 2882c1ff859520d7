"""Temporal anti-aliasing (port of granite_tpu/ops/taa.py; reference
renderer/post/temporal.cpp + assets/shaders/post/taa_resolve.frag +
post/reprojection*.h).

  * Jitter phase tables (temporal.cpp): FXAA 2-phase, SMAA T2X 2-phase,
    TAA 8/16-phase; a phase translates clip space by 2*offset/size.
    TemporalJitter is host numpy, copied because its module imports jax.
  * TAA colour space: max3 tonemap (c*8 / (max3 + 1)) then RGB -> YCgCo;
    the history is carried in it.
  * Resolve (TAA_QUALITY 1): reprojection by motion vectors dilated
    toward the nearest depth of the 5-tap cross, or by the camera alone
    from depth; rounded-corner neighbourhood AABB clamp; blend
    (1 + 2*min(50*|mv|, 1)) / 16.
Plain PyTorch: the reference is jnp, not a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .hdr import _sample_bilinear_uv, shift, uv_grid

# -- jitter tables (pixel offsets; temporal.cpp) ------------------------------

JITTER_FXAA_2PHASE = np.array([[0.5, 0.0], [0.0, 0.5]], np.float32)
JITTER_SMAA_T2X = np.array([[-0.25, -0.25], [0.25, 0.25]], np.float32)
JITTER_TAA_8PHASE = 0.125 * np.array(
    [[-7, 1], [-5, -5], [-1, -3], [3, -7],
     [-5, -1], [7, 7], [1, 3], [-3, 5]], np.float32)
JITTER_TAA_16PHASE = 0.125 * np.array(
    [[-8, 0], [-6, -4], [-3, -2], [-2, -6], [1, -1], [2, -5], [6, -7],
     [5, -3], [4, 1], [7, 4], [3, 5], [0, 7], [-1, 3], [-4, 6],
     [-7, 8], [-5, 2]], np.float32)

# NDC xy -> UV (u = 0.5 x + 0.5, v = 0.5 y + 0.5).
UV_REMAP = np.array([[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5],
                     [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


class TemporalJitter:
    """Steps a jitter phase; produces jittered view-proj matrices and the
    TAA reprojection matrix (post/temporal.cpp:40)."""

    def __init__(self, phases: np.ndarray, width: int, height: int):
        self.phases = np.asarray(phases, np.float32)
        self.width = width
        self.height = height
        self.phase = 0
        self._saved_nojitter = []     # ring of the last two un-jittered VPs

    def jitter_matrix(self) -> np.ndarray:
        """Clip-space translation for the current phase."""
        ox, oy = self.phases[self.phase % len(self.phases)]
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = 2.0 * ox / self.width
        m[1, 3] = 2.0 * oy / self.height
        return m

    def step(self, view_proj: np.ndarray) -> np.ndarray:
        """Advance one frame -> the jittered view-proj to render with; the
        un-jittered one is kept for reprojection."""
        self._saved_nojitter.append(np.asarray(view_proj, np.float32))
        if len(self._saved_nojitter) > 2:
            self._saved_nojitter.pop(0)
        jittered = (self.jitter_matrix() @ view_proj).astype(np.float32)
        self.phase += 1
        return jittered

    def unstep(self) -> None:
        """Rewind one step() (the phase only: the saved ring is the same
        for a still camera)."""
        self.phase -= 1

    def last_jitter_uv(self) -> np.ndarray:
        """The last step()'s jitter in UV units (o / size)."""
        ox, oy = self.phases[(self.phase - 1) % len(self.phases)]
        return np.array([ox / self.width, oy / self.height], np.float32)

    def reproject_matrix(self) -> np.ndarray:
        """Current NDC (x, y, z, 1) -> previous-frame UV (after xy / w):
        uv_remap @ prev VP @ inv(current VP)."""
        cur = self._saved_nojitter[-1]
        prev = self._saved_nojitter[0]
        return (UV_REMAP @ prev @ np.linalg.inv(cur)).astype(np.float32)


# -- TAA colour space (reprojection_color_space.h) ----------------------------

def _max3(c):
    return torch.maximum(torch.maximum(c[..., 0], c[..., 1]), c[..., 2])


def hdr_to_taa(c):
    c = c * 8.0
    t = c / (_max3(c) + 1.0)[..., None]
    y = 0.25 * t[..., 0] + 0.5 * t[..., 1] + 0.25 * t[..., 2]
    cg = 0.5 * t[..., 1] - 0.25 * t[..., 0] - 0.25 * t[..., 2]
    co = 0.5 * t[..., 0] - 0.5 * t[..., 2]
    return torch.stack([y, cg, co], dim=-1)


def taa_to_hdr(c):
    tmp = c[..., 0] - c[..., 1]
    rgb = torch.stack([tmp + c[..., 2], c[..., 0] + c[..., 1],
                       tmp - c[..., 2]], dim=-1)
    rgb = rgb.clamp(0.0, 0.999)
    return (1.0 / 8.0) * rgb / (1.0 - _max3(rgb))[..., None]


def clamp_taa_range(history):
    """Clip a TAA-space colour to Y in [0, 1], Cg/Co in [-1, 1]."""
    y = history[..., 0].clamp(0.0, 1.0)
    return torch.cat([y[..., None], history[..., 1:].clamp(-1.0, 1.0)],
                     dim=-1)


# -- resolve ------------------------------------------------------------------

_CROSS = ((-1, 0), (1, 0), (0, -1), (0, 1))
_DIAGONAL = ((-1, -1), (1, 1), (-1, 1), (1, -1))


def _clamp_box_aabb(color, lo, hi):
    """REPROJECTION_CLAMP_METHOD_AABB (reprojection.h:31-46)."""
    center = 0.5 * (lo + hi)
    radius = (0.5 * (hi - lo)).clamp_min(1e-4)
    v = color - center
    units = (v / radius).abs()
    max_unit = torch.maximum(torch.maximum(units[..., 0], units[..., 1]),
                             units[..., 2])[..., None]
    return torch.where(max_unit > 1.0, center + v / max_unit, color)


def neighborhood_bounds(cur):
    """Rounded-corner neighbourhood: the mean of the cross's and the
    3x3's per-channel min and max -> (lo, hi)."""
    lo_x = hi_x = cur
    for dy, dx in _CROSS:
        n = shift(cur, dy, dx)
        lo_x = torch.minimum(lo_x, n)
        hi_x = torch.maximum(hi_x, n)
    lo_d, hi_d = lo_x, hi_x
    for dy, dx in _DIAGONAL:
        n = shift(cur, dy, dx)
        lo_d = torch.minimum(lo_d, n)
        hi_d = torch.maximum(hi_d, n)
    return 0.5 * (lo_x + lo_d), 0.5 * (hi_x + hi_d)


def dilate_motion(depth, mv):
    """Each pixel takes the motion vector of the nearest depth (largest
    reverse-Z) of its 5-tap cross, the first in tap order on ties."""
    best_d, best_mv = depth, mv
    for dy, dx in _CROSS:
        nd = shift(depth, dy, dx)
        nmv = shift(mv, dy, dx)
        best_mv = torch.where((nd > best_d)[..., None], nmv, best_mv)
        best_d = torch.maximum(best_d, nd)
    return best_mv


def taa_resolve(current_hdr, prev_taa, depth, reproj, width: int,
                height: int, mv=None):
    """taa_resolve.frag, TAA_QUALITY 1.

    current_hdr: (H, W, 3) linear HDR of this (jittered) frame; prev_taa:
    (H, W, 3) last frame's history in TAA space; depth: (H, W) reverse-Z;
    reproj: (4, 4) TemporalJitter.reproject_matrix(); mv: optional (H, W,
    2) motion vectors uv_cur - uv_prev — without them the camera
    reprojects the nearest depth of the 5-tap cross.
    -> (out_hdr, new_history_taa)."""
    cur = hdr_to_taa(current_hdr)
    uu, vv = uv_grid(height, width, cur.device)
    if mv is None:
        best_d = depth
        for dy, dx in _CROSS:
            best_d = torch.maximum(best_d, shift(depth, dy, dx))
        ndc = torch.stack([2 * uu - 1, 2 * vv - 1, best_d,
                           torch.ones_like(uu)], dim=-1)
        rp = ndc @ reproj.T
        # The reference's expression: w = 0 gives 0 * (x / 1e-12).
        old_uv = rp[..., :2] / rp[..., 3:4].abs().clamp_min(1e-12) \
            * torch.sign(rp[..., 3:4])
        mv = torch.stack([uu, vv], -1) - old_uv
    else:
        mv = dilate_motion(depth, mv)
        old_uv = torch.stack([uu, vv], -1) - mv
    mv_len = torch.sqrt((mv * mv).sum(-1) + 1e-20)
    mv_fast = (mv_len * 50.0).clamp_max(1.0)

    history = clamp_taa_range(
        _sample_bilinear_uv(prev_taa, old_uv[..., 0], old_uv[..., 1]))
    lo, hi = neighborhood_bounds(cur)
    history = _clamp_box_aabb(history, lo, hi)
    # Off-screen reprojection falls back to the current sample.
    on_screen = ((old_uv[..., 0] >= 0) & (old_uv[..., 0] <= 1)
                 & (old_uv[..., 1] >= 0) & (old_uv[..., 1] <= 1))
    history = torch.where(on_screen[..., None], history, cur)

    lerp_factor = ((1.0 + 2.0 * mv_fast) / 16.0)[..., None]
    out = history + (cur - history) * lerp_factor
    return taa_to_hdr(out), out
