# Frozen copy of granite_tpu_torch/app/bench_scene.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""Procedural scenes of the viewer (numpy copies of
granite_tpu/app/bench_scene.py, scene_viewer.build_default_test_scene and
triangle_demo.checkerboard, whose modules import jax).
tests/test_torch_slice.py holds each copy equal to its original.

build_bench_scene: the Sponza-class benchmark atrium (~260k triangles,
textured floor, colonnade, dense spheres and cubes, 5 PBR materials, 8
point lights).  build_default_test_scene: the small scene of the golden
images (floor, cubes and spheres, a glass sphere, 4 point lights and a
spot light).
"""

from __future__ import annotations

import numpy as np

from ..math.muglm import look_at_quat
from ..scene.mesh_util import (
    cube_mesh, cylinder_mesh, plane_mesh, sphere_mesh,
)
from ..scene.scene_formats import (
    ALPHA_MODE_BLEND, LIGHT_POINT, LIGHT_SPOT, LightData, MaterialData,
    NodeData, SceneInfo,
)


# The viewer config bench.py renders the bench scene with (BASELINE
# config 3: deferred HDR, the 2048^2 sun map, visibility compaction to
# 163,840 triangles, the sun's PCF term at half resolution).
BENCH_CONFIG = {"renderer": "deferred", "hdrBloom": True,
                "shadowMapResolution": 2048, "rasterMaxVisible": 163840,
                "shadowTermHalfRes": True}


def checkerboard(size: int = 256, tiles: int = 8) -> np.ndarray:
    """Procedural checkerboard texture (linear float RGBA)."""
    yy, xx = np.mgrid[0:size, 0:size]
    c = (((xx * tiles // size) ^ (yy * tiles // size)) & 1).astype(np.float32)
    img = np.empty((size, size, 4), np.float32)
    img[..., 0] = 0.9 * c + 0.05
    img[..., 1] = 0.4 * c + 0.1
    img[..., 2] = 0.2 * (1.0 - c) + 0.1
    img[..., 3] = 1.0
    return img


def build_bench_scene(target_tris: int = 260_000,
                      seed: int = 11) -> SceneInfo:
    rng = np.random.RandomState(seed)
    info = SceneInfo()
    checker = (np.clip(checkerboard(512, tiles=16), 0, 1) * 255).astype(
        np.uint8)
    noise = rng.randint(60, 200, (256, 256, 4), np.uint8)
    noise[..., 3] = 255
    info.images = [checker, noise]
    info.image_srgb = [True, True]
    info.materials = [
        MaterialData(name="floor", base_color_image=0,
                     roughness_factor=0.7),
        MaterialData(name="stone", base_color_image=1,
                     roughness_factor=0.9),
        MaterialData(name="marble",
                     base_color_factor=np.array([.8, .78, .72, 1],
                                                np.float32),
                     roughness_factor=0.35),
        MaterialData(name="brass",
                     base_color_factor=np.array([.9, .7, .3, 1],
                                                np.float32),
                     roughness_factor=0.3, metallic_factor=1.0),
        MaterialData(name="fabric",
                     base_color_factor=np.array([.6, .12, .1, 1],
                                                np.float32),
                     roughness_factor=0.95),
    ]
    sphere_hi = sphere_mesh(32, 3)
    sphere_md = sphere_mesh(24, 2)
    cyl = cylinder_mesh(48, 1)
    info.meshes = [plane_mesh(0, tiles=24.0), cyl, sphere_hi, sphere_md,
                   cube_mesh(4)]
    tris_per = [2, 96 * 2, 32 * 64 * 2, 24 * 48 * 2, 12]

    root = NodeData(name="root")
    nodes = [root]

    def add(name, mesh, t, r=None, s=None):
        nodes.append(NodeData(
            name=name, meshes=[mesh],
            translation=np.asarray(t, np.float32),
            rotation=np.asarray(r if r is not None else [1, 0, 0, 0],
                                np.float32),
            scale=np.asarray(s if s is not None else [1, 1, 1],
                             np.float32)))

    add("floor", 0, [0, 0, 0], s=[30, 1, 30])
    total = tris_per[0]
    for i in range(24):
        a = 2 * np.pi * i / 24
        add(f"col{i}", 1, [18 * np.cos(a), 3.0, 18 * np.sin(a)],
            s=[0.8, 3.0, 0.8])
        total += tris_per[1]
    i = 0
    while total < target_tris:
        x = rng.uniform(-14, 14)
        z = rng.uniform(-14, 14)
        kind = i % 3
        mesh = [2, 3, 4][kind]
        scale = [0.9, 0.7, 0.8][kind] * rng.uniform(0.7, 1.3)
        y = [1.0, 0.8, 0.8][kind] * scale
        q = np.array([np.cos(i * 0.3), 0, np.sin(i * 0.3), 0], np.float32)
        add(f"obj{i}", mesh, [x, y, z], r=q, s=[scale] * 3)
        total += tris_per[mesh]
        i += 1
    root.children = list(range(1, len(nodes)))
    info.nodes = nodes
    info.roots = [0]

    for k in range(8):
        a = 2 * np.pi * k / 8
        info.lights.append(LightData(
            type=LIGHT_POINT,
            color=np.asarray([(2, .6, .4), (.5, 2, .6), (.5, .6, 2),
                              (2, 2, .6)][k % 4], np.float32),
            intensity=8.0, range=12.0))
        nodes.append(NodeData(
            name=f"plight{k}",
            translation=np.array([10 * np.cos(a), 2.5, 10 * np.sin(a)],
                                 np.float32),
            light=len(info.lights) - 1))
        root.children.append(len(nodes) - 1)
    return info


def build_default_test_scene() -> SceneInfo:
    """Floor, a ring of cubes and spheres, a glass sphere, four colored
    point lights and a spot light."""
    info = SceneInfo()
    checker = (np.clip(checkerboard(256), 0, 1) * 255).astype(np.uint8)
    info.images = [checker]
    info.image_srgb = [True]
    info.materials = [
        MaterialData(name="floor", base_color_image=0, roughness_factor=0.8,
                     metallic_factor=0.0),
        MaterialData(name="red",
                     base_color_factor=np.array([0.8, 0.1, 0.1, 1],
                                                np.float32),
                     roughness_factor=0.35, metallic_factor=0.0),
        MaterialData(name="metal",
                     base_color_factor=np.array([0.9, 0.85, 0.4, 1],
                                                np.float32),
                     roughness_factor=0.25, metallic_factor=1.0),
        MaterialData(name="glass",
                     base_color_factor=np.array([0.4, 0.7, 0.9, 0.45],
                                                np.float32),
                     roughness_factor=0.1, metallic_factor=0.0,
                     alpha_mode=ALPHA_MODE_BLEND),
    ]
    info.meshes = [plane_mesh(0, tiles=8.0), cube_mesh(1), sphere_mesh(24, 2),
                   sphere_mesh(20, 3)]
    root = NodeData(name="root")
    nodes = [root]
    nodes.append(NodeData(name="floor",
                          scale=np.array([12, 1, 12], np.float32),
                          meshes=[0]))
    rng = np.random.RandomState(7)
    for i in range(8):
        a = 2 * np.pi * i / 8
        nodes.append(NodeData(
            name=f"obj{i}",
            translation=np.array([5 * np.cos(a), 1.0, 5 * np.sin(a)],
                                 np.float32),
            rotation=np.array([np.cos(a / 2), 0, np.sin(a / 2), 0],
                              np.float32),
            scale=np.full(3, 0.7 + 0.3 * rng.rand(), np.float32),
            meshes=[1 + i % 2]))
    nodes.append(NodeData(name="glass_sphere",
                          translation=np.array([0, 1.4, 0], np.float32),
                          scale=np.full(3, 1.2, np.float32), meshes=[3]))
    colors = [(4.0, 0.5, 0.5), (0.5, 4.0, 0.5), (0.5, 0.5, 4.0),
              (3.0, 3.0, 0.5)]
    for i, c in enumerate(colors):
        a = 2 * np.pi * (i + 0.5) / 4
        info.lights.append(LightData(type=LIGHT_POINT,
                                     color=np.asarray(c, np.float32),
                                     intensity=4.0, range=8.0))
        nodes.append(NodeData(
            name=f"light{i}",
            translation=np.array([3.2 * np.cos(a), 2.0, 3.2 * np.sin(a)],
                                 np.float32),
            light=len(info.lights) - 1))
    info.lights.append(LightData(type=LIGHT_SPOT,
                                 color=np.array([1, 1, 1], np.float32),
                                 intensity=60.0, range=16.0,
                                 inner_cone=0.3, outer_cone=0.55))
    spot_node = NodeData(name="spot",
                         translation=np.array([0, 6.0, 0], np.float32),
                         light=len(info.lights) - 1)
    # node orientation: local -Z points down -> conjugate of the
    # world->view look_at quaternion.
    q = look_at_quat([0.01, -1.0, 0.01], [0, 0, -1])
    spot_node.rotation = np.array([q[0], -q[1], -q[2], -q[3]], np.float32)
    nodes.append(spot_node)
    root.children = list(range(1, len(nodes)))
    info.nodes = nodes
    info.roots = [0]
    return info
