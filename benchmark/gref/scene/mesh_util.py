# Frozen copy of granite_tpu_torch/scene/mesh_util.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""Procedural mesh generators (copy of the builders of
granite_tpu/scene/mesh_util.py the port uses; reference:
renderer/mesh_util.{hpp,cpp}).  tests/test_torch_host_copies.py holds
each builder equal to its original."""

from __future__ import annotations

import numpy as np

from .scene_formats import MeshData


def cube_mesh(material: int = -1) -> MeshData:
    """Unit cube [-1,1]^3 with per-face normals/uvs (mesh_util CubeMesh)."""
    faces = [
        # normal, up, right
        ((0, 0, 1), (0, 1, 0), (1, 0, 0)),
        ((0, 0, -1), (0, 1, 0), (-1, 0, 0)),
        ((1, 0, 0), (0, 1, 0), (0, 0, -1)),
        ((-1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((0, 1, 0), (0, 0, -1), (1, 0, 0)),
        ((0, -1, 0), (0, 0, 1), (1, 0, 0)),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (n, u, r) in enumerate(faces):
        n = np.array(n, np.float32)
        u = np.array(u, np.float32)
        r = np.array(r, np.float32)
        base = len(pos)
        for (su, sr), tuv in (((-1, -1), (0, 1)), ((-1, 1), (1, 1)),
                              ((1, 1), (1, 0)), ((1, -1), (0, 0))):
            pos.append(n + su * u + sr * r)
            nrm.append(n)
            uv.append(tuv)
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    m = MeshData(positions=np.array(pos, np.float32),
                 normals=np.array(nrm, np.float32),
                 uvs=np.array(uv, np.float32),
                 indices=np.array(idx, np.int32), material=material)
    return m.finalize()


def sphere_mesh(density: int = 16, material: int = -1) -> MeshData:
    """UV sphere of radius 1 (lat-long parameterization)."""
    lat = np.linspace(0, np.pi, density + 1)
    lon = np.linspace(0, 2 * np.pi, 2 * density + 1)
    LA, LO = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(LA) * np.cos(LO)
    y = np.cos(LA)
    z = np.sin(LA) * np.sin(LO)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([LO / (2 * np.pi), LA / np.pi],
                   axis=-1).reshape(-1, 2).astype(np.float32)
    W = 2 * density + 1
    tri = []
    for i in range(density):
        for j in range(2 * density):
            a = i * W + j
            b = a + 1
            c = a + W
            d = c + 1
            tri += [[a, c, b], [b, c, d]]
    m = MeshData(positions=pos, normals=pos.copy(), uvs=uvs,
                 indices=np.array(tri, np.int32), material=material)
    return m.finalize()


def plane_mesh(material: int = -1, tiles: float = 1.0) -> MeshData:
    """Unit XZ plane at y=0, normal +Y (ground patch base)."""
    pos = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                   np.float32)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
    uv = np.array([[0, 0], [tiles, 0], [tiles, tiles], [0, tiles]],
                  np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return MeshData(positions=pos, normals=nrm, uvs=uv, indices=idx,
                    material=material).finalize()


def cylinder_mesh(density: int = 16, material: int = -1) -> MeshData:
    ang = np.linspace(0, 2 * np.pi, density + 1)
    ring = np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], axis=-1)
    top = ring + np.array([0, 1, 0], np.float32)
    bot = ring + np.array([0, -1, 0], np.float32)
    pos = np.concatenate([top, bot]).astype(np.float32)
    nrm = np.concatenate([ring, ring]).astype(np.float32)
    u = ang / (2 * np.pi)
    uv = np.concatenate([np.stack([u, np.zeros_like(u)], -1),
                         np.stack([u, np.ones_like(u)], -1)]).astype(
                             np.float32)
    W = density + 1
    tri = []
    for j in range(density):
        tri += [[j, j + W, j + 1], [j + 1, j + W, j + W + 1]]
    return MeshData(positions=pos, normals=nrm, uvs=uv,
                    indices=np.array(tri, np.int32),
                    material=material).finalize()
