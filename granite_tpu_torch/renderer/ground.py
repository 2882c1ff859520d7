"""Ground / terrain patches (port of granite_tpu/renderer/ground.py;
reference: renderer/ground.{hpp,cpp}, a clip-map style LOD heightmap
terrain).

Two paths:
  * ground_mesh: displacement baked into the vertex buffer at load (no
    per-frame cost, no LOD).  The viewer takes it without a scene file.
  * GroundLOD: a flat grid displaced at transform time from a heightmap
    mip stack with per-vertex distance LOD; the LOD varies continuously
    across vertices, so patch edge stitching is unnecessary.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.texture import WRAP_CLAMP, build_mips, sample_trilinear
from ..scene.scene_formats import MeshData


def fbm_heightmap(n: int = 256, octaves: int = 5, seed: int = 0,
                  amplitude: float = 1.0) -> np.ndarray:
    """Procedural fractal heightmap in [0, amplitude], periodic."""
    rng = np.random.RandomState(seed)
    out = np.zeros((n, n), np.float32)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        res = 2 ** (o + 2)
        if res > n:
            break
        coarse = rng.rand(res, res).astype(np.float32)
        # periodic bilinear upsample to n x n
        yi = np.linspace(0, res, n, endpoint=False)
        xi = np.linspace(0, res, n, endpoint=False)
        y0 = np.floor(yi).astype(int) % res
        x0 = np.floor(xi).astype(int) % res
        fy = (yi - np.floor(yi))[:, None]
        fx = (xi - np.floor(xi))[None, :]
        y1 = (y0 + 1) % res
        x1 = (x0 + 1) % res
        a = coarse[np.ix_(y0, x0)]
        b = coarse[np.ix_(y0, x1)]
        c = coarse[np.ix_(y1, x0)]
        d = coarse[np.ix_(y1, x1)]
        layer = (a * (1 - fx) + b * fx) * (1 - fy) + \
            (c * (1 - fx) + d * fx) * fy
        out += amp * layer
        total += amp
        amp *= 0.5
    out /= total
    return (out * amplitude).astype(np.float32)


def grid_triangles(grid: int) -> np.ndarray:
    """Two triangles a quad of a (grid+1)^2-vertex grid, row by row."""
    tri = []
    W = grid + 1
    for y in range(grid):
        for x in range(grid):
            a = y * W + x
            tri += [[a, a + W, a + 1], [a + 1, a + W, a + W + 1]]
    return np.array(tri, np.int32)


def flat_grid_mesh(world_size: float, grid: int, material: int = -1,
                   uv_tiles: float = 16.0) -> MeshData:
    """Flat XZ grid (the GroundLOD base mesh; heights come from the
    per-frame displacer).  Callers widen its AABB by the amplitude."""
    lin = np.linspace(0.0, 1.0, grid + 1, dtype=np.float32)
    uu, vv = np.meshgrid(lin, lin)
    pos = np.stack([(uu - 0.5) * world_size, np.zeros_like(uu),
                    (vv - 0.5) * world_size], axis=-1).reshape(-1, 3)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (len(pos), 1))
    uv = np.stack([uu * uv_tiles, vv * uv_tiles], axis=-1).reshape(-1, 2)
    return MeshData(positions=pos.astype(np.float32), normals=nrm,
                    uvs=uv.astype(np.float32), indices=grid_triangles(grid),
                    material=material).finalize()


class GroundLOD:
    """Per-vertex LOD heightmap displacer (GroundPatch LOD analogue).

    heightmap: (N, N) float; stored as an (L, N, N, 3) mip stack of
    [height, dh/dx, dh/dz] on `device`, so one trilinear sample yields
    the displacement and the normal at the selected LOD."""

    def __init__(self, heightmap: np.ndarray, world_size: float = 64.0,
                 grid: int = 128, max_lod: float = 5.0,
                 base_patch_size: int = 64, device="cpu"):
        self.world_size = world_size
        self.grid = grid
        n = heightmap.shape[0]
        texel = world_size / n
        dhdx = (np.roll(heightmap, -1, 1) - np.roll(heightmap, 1, 1)) \
            / (2 * texel)
        dhdz = (np.roll(heightmap, -1, 0) - np.roll(heightmap, 1, 0)) \
            / (2 * texel)
        hmap = np.stack([heightmap, dhdx, dhdz], -1).astype(np.float32)
        levels = min(int(max_lod) + 1, int(np.log2(n)) + 1)
        self.maps = build_mips(torch.as_tensor(hmap, device=device), levels)
        # LOD 0 reach: until one heightmap texel subtends less than ~a
        # pixel; bigger patches go coarse sooner (ground.cpp
        # get_lod_from_aabb scales by patch size).
        self.lod0_distance = world_size / n * 1000.0 * (64.0
                                                        / base_patch_size)

    def displace(self, world_pos, world_normal, vertex_mask, camera_pos):
        u = world_pos[:, 0] / self.world_size + 0.5
        v = world_pos[:, 2] / self.world_size + 0.5
        d = world_pos - camera_pos
        dist = torch.sqrt((d * d).sum(-1).clamp_min(1e-6))
        lod = torch.log2((dist / self.lod0_distance).clamp_min(1.0)).clamp(
            0.0, self.maps.shape[0] - 1.0)
        s = sample_trilinear(self.maps, u, v, lod, wrap=WRAP_CLAMP)
        h = s[..., 0]
        zero = torch.zeros_like(h)
        new_pos = world_pos + torch.where(
            vertex_mask[:, None], torch.stack([zero, h, zero], -1), 0.0)
        n = torch.stack([-s[..., 1], torch.ones_like(h), -s[..., 2]], -1)
        n = n / torch.sqrt((n * n).sum(-1, keepdim=True))
        new_nrm = torch.where(vertex_mask[:, None], n, world_normal)
        return new_pos, new_nrm


def ground_mesh(heightmap: np.ndarray, world_size: float = 64.0,
                grid: int = 128, material: int = -1,
                uv_tiles: float = 16.0) -> MeshData:
    """Heightmap-displaced grid mesh with finite-difference normals."""
    n = heightmap.shape[0]
    lin = np.linspace(0.0, 1.0, grid + 1, dtype=np.float32)
    uu, vv = np.meshgrid(lin, lin)
    hx = (uu * (n - 1)).astype(int)
    hy = (vv * (n - 1)).astype(int)
    h = heightmap[hy, hx]
    pos = np.stack([(uu - 0.5) * world_size, h,
                    (vv - 0.5) * world_size], axis=-1).reshape(-1, 3)
    # normals from central differences on the heightmap
    hxp = heightmap[hy, np.minimum(hx + 1, n - 1)]
    hxm = heightmap[hy, np.maximum(hx - 1, 0)]
    hyp = heightmap[np.minimum(hy + 1, n - 1), hx]
    hym = heightmap[np.maximum(hy - 1, 0), hx]
    texel = world_size / (n - 1)
    dhdx = (hxp - hxm) / (2 * texel)
    dhdz = (hyp - hym) / (2 * texel)
    nrm = np.stack([-dhdx, np.ones_like(h), -dhdz], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = np.stack([uu * uv_tiles, vv * uv_tiles], axis=-1)
    return MeshData(positions=pos.astype(np.float32),
                    normals=nrm.reshape(-1, 3).astype(np.float32),
                    uvs=uv.reshape(-1, 2).astype(np.float32),
                    indices=grid_triangles(grid),
                    material=material).finalize()
