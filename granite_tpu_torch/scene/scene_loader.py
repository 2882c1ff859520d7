"""SceneLoader: a glTF file, or a `.scene` JSON document composing several
(copy of granite_tpu/scene/scene_loader.py; reference: renderer/
scene_loader.{hpp,cpp}, which loads glTF directly or a JSON document
composing scenes and meshes with per-instance transforms, ocean and
terrain blocks).

Schema:
{
  "scenes": [
    {"path": "a.gltf",
     "instances": [{"translation": [..], "rotation": [w,x,y,z],
                    "scale": [..]}, ...]}        # default: one identity
  ],
  "ocean":   true | {OceanConfig fields},        # composition extensions
  "terrain": true | {"worldSize": .., "amplitude": .., "grid": ..}
}

Two faults of the original are fixed here.  It appends each source
skin once and then overwrites that skin's joints for every instance, so
a file instanced twice gets one skin whose joints are the last
instance's bones, and every instance is deformed onto the last one's
place.  And it appends each source camera once with its node index
left in the source's numbering, so a scene camera takes the transform
of another node (the one an instance root earlier).  This copy gives
every instance its own skins and cameras, with joints and camera nodes
remapped onto that instance's nodes.  With one instance the records
agree but for the camera's node.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from .gltf import GLTFParser
from .scene_formats import NodeData, SceneInfo

_IMAGE_FIELDS = ("base_color_image", "metallic_roughness_image",
                 "normal_image", "occlusion_image", "emissive_image")


def _merge_scene(dst: SceneInfo, src: SceneInfo, instances) -> None:
    """Append src under one new root node per instance, remapping ids."""
    mesh_off = len(dst.meshes)
    mat_off = len(dst.materials)
    img_off = len(dst.images)
    light_off = len(dst.lights)

    for md in src.meshes:
        m2 = copy.copy(md)
        if m2.material >= 0:
            m2.material = m2.material + mat_off
        dst.meshes.append(m2)
    for mat in src.materials:
        m2 = copy.copy(mat)
        for attr in _IMAGE_FIELDS:
            v = getattr(m2, attr)
            if v is not None:
                setattr(m2, attr, v + img_off)
        dst.materials.append(m2)
    dst.images.extend(src.images)
    dst.image_srgb.extend(src.image_srgb)
    dst.lights.extend(src.lights)

    for inst in instances:
        node_off = len(dst.nodes)
        root = NodeData(name=f"instance@{node_off}")
        if "translation" in inst:
            root.translation = np.asarray(inst["translation"], np.float32)
        if "rotation" in inst:
            root.rotation = np.asarray(inst["rotation"], np.float32)
        if "scale" in inst:
            root.scale = np.asarray(inst["scale"], np.float32)
        dst.nodes.append(root)
        dst.roots.append(node_off)
        base = len(dst.nodes)
        # this instance's own skins and cameras, on its own nodes
        skin_off = len(dst.skins)
        for sk in src.skins:
            s2 = copy.copy(sk)
            s2.joints = sk.joints + base
            dst.skins.append(s2)
        cam_off = len(dst.cameras)
        for cam in src.cameras:
            c2 = copy.copy(cam)
            if c2.node is not None:
                c2.node = c2.node + base
            dst.cameras.append(c2)
        for nd in src.nodes:
            n2 = copy.copy(nd)
            n2.children = [c + base for c in nd.children]
            n2.meshes = [m + mesh_off for m in nd.meshes]
            if n2.light is not None:
                n2.light = n2.light + light_off
            if n2.camera is not None:
                n2.camera = n2.camera + cam_off
            if n2.skin is not None:
                n2.skin = n2.skin + skin_off
            dst.nodes.append(n2)
        root.children = [r + base for r in src.roots]
        # animations retarget per instance
        for ad in src.animations:
            a2 = copy.copy(ad)
            a2.channels = [dict(ch, node=ch["node"] + base)
                           for ch in ad.channels]
            dst.animations.append(a2)


class SceneLoader:
    """load_scene(path): .gltf/.glb directly, or .scene composition."""

    def __init__(self, path: str):
        self.ocean_config = None
        self.terrain_config = None
        if path.endswith(".scene") or path.endswith(".json"):
            self.info = self._load_composed(path)
        else:
            self.info = GLTFParser(path).get_scene()

    def _load_composed(self, path: str) -> SceneInfo:
        base_dir = os.path.dirname(os.path.abspath(path))
        with open(path) as f:
            doc = json.load(f)
        info = SceneInfo()
        for entry in doc.get("scenes", []):
            sub = GLTFParser(os.path.join(base_dir,
                                          entry["path"])).get_scene()
            instances = entry.get("instances", [{}])
            _merge_scene(info, sub, instances)
        if doc.get("ocean"):
            self.ocean_config = doc["ocean"] if isinstance(
                doc["ocean"], dict) else {}
        if doc.get("terrain"):
            self.terrain_config = doc["terrain"] if isinstance(
                doc["terrain"], dict) else {}
        return info

    def get_scene(self) -> SceneInfo:
        return self.info
