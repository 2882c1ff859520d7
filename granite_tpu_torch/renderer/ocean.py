"""Ocean renderable (port of granite_tpu/renderer/ocean.py; reference:
renderer/ocean.{hpp,cpp}).

An `Ocean` owns the initial spectrum and the frequency grids (tensors on
its device), contributes an "ocean-fft" pass producing the packed
(L, N, N, 5) height/displacement/gradient mip stack, and a vertex
displacer that the frame's vertex transform applies to the ocean grid's
vertices (the reference's ocean.vert heightmap fetch, done at transform
time).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import ocean as O
from ..ops.texture import WRAP_REPEAT, build_mips, sample_level, \
    sample_trilinear
from ..scene.scene_formats import MeshData
from .ground import grid_triangles


@dataclass
class OceanConfig:
    """Mirror of Ocean::Config defaults (ocean.hpp:79)."""
    fft_resolution: int = 256
    grid_resolution: int = 128
    world_size: float = 64.0
    amplitude: float = 0.3
    wind_velocity: tuple = (6.0, 3.0)
    lambda_disp: float = 1.2
    height_scale: float = 1.0
    animation_period: float = 256.0


class Ocean:
    # Vertex LOD count (quad_lod mip chain depth, ocean.cpp:208-213).
    num_lods = 6

    def __init__(self, config: OceanConfig = OceanConfig(), seed: int = 0,
                 device="cpu"):
        self.config = config
        n = config.fft_resolution
        ws = (config.world_size, config.world_size)
        self.h0 = torch.as_tensor(O.generate_distribution(
            n, ws, config.amplitude, config.wind_velocity, seed=seed),
            device=device)
        self.kx, self.ky, self.k_len = O._freq_grids(n, ws, device)

    def grid_mesh(self, material: int = -1) -> MeshData:
        """Flat grid covering one heightmap period, UV in [0,1]."""
        g = self.config.grid_resolution
        ws = self.config.world_size
        lin = np.linspace(0.0, 1.0, g + 1, dtype=np.float32)
        uu, vv = np.meshgrid(lin, lin)
        pos = np.stack([(uu - 0.5) * ws, np.zeros_like(uu),
                        (vv - 0.5) * ws], axis=-1).reshape(-1, 3)
        uv = np.stack([uu, vv], axis=-1).reshape(-1, 2)
        nrm = np.tile(np.array([0, 1, 0], np.float32), (len(pos), 1))
        return MeshData(positions=pos.astype(np.float32), normals=nrm,
                        uvs=uv.astype(np.float32),
                        indices=grid_triangles(g),
                        material=material).finalize()

    def fft_pass(self, ctx):
        """Graph pass: spectrum evolve + 3 IFFTs -> packed mip stack
        (L, N, N, 5); LOD selection happens per vertex in displace()."""
        t = ctx.params["ocean_time"]
        height, disp, grad = O.ocean_maps(
            self.h0, self.kx, self.ky, self.k_len, t,
            period=self.config.animation_period)
        maps = torch.cat([height[..., None] * self.config.height_scale,
                          disp, grad], dim=-1).to(torch.float32)
        levels = min(self.num_lods,
                     int(np.log2(self.config.fft_resolution)) + 1)
        return {"ocean-maps": build_mips(maps, levels)}

    def displace(self, world_pos, world_normal, vertex_mask, maps,
                 camera_pos=None):
        """Vertex displacement + analytic normals from the gradient maps.

        world_pos: (V, 3); vertex_mask: (V,) bool for ocean vertices;
        maps: (L, N, N, 5) mip stack.  UVs derive from world xz (periodic
        tiling, ocean.cpp:411).  camera_pos: when given, per-vertex
        distance selects the displacement mip, trilinearly blended (a
        continuous LOD, so no patch stitching)."""
        ws = self.config.world_size
        u = world_pos[:, 0] / ws + 0.5
        v = world_pos[:, 2] / ws + 0.5
        if camera_pos is not None:
            d = world_pos - camera_pos
            dist = torch.sqrt((d * d).sum(-1).clamp_min(1e-6))
            # LOD 0 holds until one displacement-map texel subtends less
            # than ~a pixel (texel size * ~1000 at 1080p), doubling per
            # level.
            lod0 = ws / self.config.fft_resolution * 1000.0
            lod = torch.log2((dist / lod0).clamp_min(1.0)).clamp(
                0.0, maps.shape[0] - 1.0)
            s = sample_trilinear(maps, u, v, lod, wrap=WRAP_REPEAT)
        else:
            s = sample_level(maps, u, v, 0, wrap=WRAP_REPEAT)
        h = s[..., 0]
        dx = -self.config.lambda_disp * s[..., 1]
        dz = -self.config.lambda_disp * s[..., 2]
        grad = s[..., 3:5] * self.config.height_scale
        disp = torch.stack([dx, h, dz], dim=-1)
        new_pos = world_pos + torch.where(vertex_mask[:, None], disp, 0.0)
        n = torch.stack([-grad[..., 0], torch.ones_like(h), -grad[..., 1]],
                        dim=-1)
        n = n / torch.sqrt((n * n).sum(-1, keepdim=True))
        new_nrm = torch.where(vertex_mask[:, None], n, world_normal)
        return new_pos, new_nrm
