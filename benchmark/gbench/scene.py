"""The benchmark's scene and camera lens, made by the benchmark itself
(gref's frozen copy of the bench-scene builder), and their hand-over to
the viewer under test."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import types

import numpy as np

from gref.app.bench_scene import build_bench_scene
from plainref.scene import scene_bounds

# The viewer's default lens (scene/camera.py: fovy 0.55 x 90 degrees; the
# bounds-framing camera of SceneViewerApplication._setup_camera(-1):
# znear a thousandth of the bounds' radius, infinite far).
FOVY = 0.5 * np.pi * 0.55
ZNEAR_PER_RADIUS = 1e-3


def build_scene(spec: dict):
    """The configuration's scene as gref dataclasses."""
    if spec.get("builder") != "bench_scene":
        raise ValueError(f"unknown scene builder {spec.get('builder')!r}")
    return build_bench_scene(int(spec.get("target_tris", 260_000)),
                             int(spec.get("seed", 11)))


def lens(info) -> dict:
    mn, mx = scene_bounds(info)
    radius = max(0.5 * float(np.linalg.norm(mx - mn)), 1e-3)
    return {"fovy": float(FOVY), "znear": radius * ZNEAR_PER_RADIUS,
            "zfar": 0.0}


def to_port(obj):
    """A gref dataclass tree -> the same tree of the port's
    scene_formats dataclasses (arrays shared, not copied)."""
    from granite_tpu_torch.scene import scene_formats as SF
    if dataclasses.is_dataclass(obj):
        cls = getattr(SF, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_port(v) for v in obj]
    return obj


def make_viewer(info, viewer_cfg: dict, lens_: dict, via_gltf: bool,
                device: str = "cuda"):
    """The port's SceneViewerApplication on the card with the benchmark's
    scene: handed over in memory (as --bench-scene builds it) or written
    as .gltf by the port's exporter into a temporary directory and loaded
    through the viewer's scene argument."""
    from granite_tpu_torch.app import bench_scene as port_bench_scene
    from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
    port_info = to_port(info)
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(viewer_cfg, f)
        args = types.SimpleNamespace(config=cfg_path, bench_scene=False,
                                     scene=None, camera_index=-1)
        if via_gltf:
            from granite_tpu_torch.scene_export import export_gltf
            args.scene = os.path.join(tmp, "scene.gltf")
            export_gltf(port_info, args.scene)
            app = SceneViewerApplication(args, device=device)
        else:
            args.bench_scene = True
            saved = port_bench_scene.build_bench_scene
            port_bench_scene.build_bench_scene = lambda *a, **k: port_info
            try:
                app = SceneViewerApplication(args, device=device)
            finally:
                port_bench_scene.build_bench_scene = saved
    app.camera.set_fovy(lens_["fovy"])
    app.camera.set_depth_range(lens_["znear"], lens_["zfar"])
    return app
