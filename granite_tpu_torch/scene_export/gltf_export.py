"""glTF 2.0 exporter (copy of granite_tpu/scene_export/gltf_export.py;
reference: scene-export/gltf_export.cpp).

Writes a SceneInfo as .gltf + .bin (+ PNG images through PIL), byte for
byte as the original does (tests/test_torch_scene_files.py).  Like the
original it writes skins and `weights` animation channels but no
JOINTS_0 / WEIGHTS_0 attributes and no morph targets, so a skinned or
morphed mesh comes back static.  chip_smoke.py writes its scene with it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..scene.scene_formats import (
    ALPHA_MODE_BLEND, ALPHA_MODE_MASK, SceneInfo,
    LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT,
)


class _BinWriter:
    def __init__(self):
        self.blob = bytearray()
        self.views = []
        self.accessors = []

    def add(self, arr: np.ndarray, target: int | None,
            comp_type: int, type_str: str, normalized=False) -> int:
        arr = np.ascontiguousarray(arr)
        off = len(self.blob)
        pad = (-off) % 4
        self.blob += b"\0" * pad
        off += pad
        self.blob += arr.tobytes()
        view = {"buffer": 0, "byteOffset": off, "byteLength": arr.nbytes}
        if target:
            view["target"] = target
        self.views.append(view)
        acc = {
            "bufferView": len(self.views) - 1,
            "componentType": comp_type,
            "count": int(arr.shape[0]),
            "type": type_str,
        }
        if normalized:
            acc["normalized"] = True
        if type_str == "VEC3" and comp_type == 5126:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1


def export_gltf(scene: SceneInfo, path: str) -> None:
    base = os.path.splitext(path)[0]
    bin_name = os.path.basename(base) + ".bin"
    w = _BinWriter()
    doc: dict = {"asset": {"version": "2.0", "generator": "granite_tpu"}}

    images = []
    for i, img in enumerate(scene.images):
        from PIL import Image
        img_name = f"{os.path.basename(base)}_img{i}.png"
        Image.fromarray(img).save(os.path.join(os.path.dirname(path) or ".",
                                               img_name))
        images.append({"uri": img_name})
    if images:
        doc["images"] = images
        doc["samplers"] = [{"magFilter": 9729, "minFilter": 9987,
                            "wrapS": 10497, "wrapT": 10497}]
        doc["textures"] = [{"source": i, "sampler": 0}
                           for i in range(len(images))]

    mats = []
    for m in scene.materials:
        out: dict = {"name": m.name, "pbrMetallicRoughness": {
            "baseColorFactor": [float(x) for x in m.base_color_factor],
            "metallicFactor": float(m.metallic_factor),
            "roughnessFactor": float(m.roughness_factor),
        }}
        pbr = out["pbrMetallicRoughness"]
        if m.base_color_image is not None:
            pbr["baseColorTexture"] = {"index": m.base_color_image}
        if m.metallic_roughness_image is not None:
            pbr["metallicRoughnessTexture"] = {
                "index": m.metallic_roughness_image}
        if m.normal_image is not None:
            out["normalTexture"] = {"index": m.normal_image,
                                    "scale": float(m.normal_scale)}
        if m.emissive_image is not None:
            out["emissiveTexture"] = {"index": m.emissive_image}
        if np.any(m.emissive_factor):
            out["emissiveFactor"] = [float(x) for x in m.emissive_factor]
        if m.alpha_mode == ALPHA_MODE_MASK:
            out["alphaMode"] = "MASK"
            out["alphaCutoff"] = float(m.alpha_cutoff)
        elif m.alpha_mode == ALPHA_MODE_BLEND:
            out["alphaMode"] = "BLEND"
        if m.two_sided:
            out["doubleSided"] = True
        mats.append(out)
    if mats:
        doc["materials"] = mats

    meshes = []
    for md in scene.meshes:
        attrs = {"POSITION": w.add(md.positions, 34962, 5126, "VEC3")}
        if md.normals is not None:
            attrs["NORMAL"] = w.add(md.normals, 34962, 5126, "VEC3")
        if md.uvs is not None:
            attrs["TEXCOORD_0"] = w.add(md.uvs, 34962, 5126, "VEC2")
        if md.tangents is not None:
            attrs["TANGENT"] = w.add(md.tangents, 34962, 5126, "VEC4")
        prim = {"attributes": attrs,
                "indices": w.add(md.indices.reshape(-1, 1).astype(np.uint32),
                                 34963, 5125, "SCALAR"),
                "mode": 4}
        if md.material >= 0:
            prim["material"] = md.material
        meshes.append({"primitives": [prim]})
    doc["meshes"] = meshes

    lights = []
    for l in scene.lights:
        t = {LIGHT_DIRECTIONAL: "directional", LIGHT_POINT: "point",
             LIGHT_SPOT: "spot"}[l.type]
        entry = {"type": t, "color": [float(x) for x in l.color],
                 "intensity": float(l.intensity)}
        if l.range > 0:
            entry["range"] = float(l.range)
        if l.type == LIGHT_SPOT:
            entry["spot"] = {"innerConeAngle": float(l.inner_cone),
                             "outerConeAngle": float(l.outer_cone)}
        lights.append(entry)
    if lights:
        doc["extensions"] = {"KHR_lights_punctual": {"lights": lights}}
        doc["extensionsUsed"] = ["KHR_lights_punctual"]

    cameras = []
    for c in scene.cameras:
        cameras.append({"type": "perspective", "perspective": {
            "yfov": float(c.fovy), "aspectRatio": float(c.aspect),
            "znear": float(c.znear), "zfar": float(c.zfar)}})
    if cameras:
        doc["cameras"] = cameras

    nodes = []
    for nd in scene.nodes:
        n: dict = {}
        if nd.name:
            n["name"] = nd.name
        if nd.children:
            n["children"] = list(map(int, nd.children))
        if np.any(nd.translation):
            n["translation"] = [float(x) for x in nd.translation]
        r = nd.rotation
        if abs(float(r[0]) - 1.0) > 1e-9 or np.any(np.abs(r[1:]) > 1e-9):
            n["rotation"] = [float(r[1]), float(r[2]), float(r[3]),
                             float(r[0])]
        if np.any(nd.scale != 1.0):
            n["scale"] = [float(x) for x in nd.scale]
        if nd.meshes:
            n["mesh"] = int(nd.meshes[0])  # 1 primitive per exported mesh
        if nd.camera is not None:
            n["camera"] = int(nd.camera)
        if nd.skin is not None:
            n["skin"] = int(nd.skin)
        if nd.light is not None:
            n["extensions"] = {"KHR_lights_punctual": {
                "light": int(nd.light)}}
        nodes.append(n)
    doc["nodes"] = nodes
    doc["scenes"] = [{"nodes": list(map(int, scene.roots))}]
    doc["scene"] = 0

    anims = []
    for ad in scene.animations:
        samplers = []
        channels = []
        for ch in ad.channels:
            times = np.asarray(ch["times"], np.float32).reshape(-1, 1)
            vals = np.asarray(ch["values"], np.float32)
            if ch["path"] == "rotation":
                if ch["interp"] == "CUBICSPLINE":
                    vals = vals[..., [1, 2, 3, 0]].reshape(len(times), -1)
                else:
                    vals = vals[:, [1, 2, 3, 0]]   # wxyz -> xyzw
            elif ch["interp"] == "CUBICSPLINE":
                vals = vals.reshape(len(times), -1)
            comps = vals.shape[1] if ch["interp"] != "CUBICSPLINE" else \
                vals.shape[1] // 3
            type_str = {1: "SCALAR", 2: "VEC2", 3: "VEC3",
                        4: "VEC4"}[comps]
            t_acc = w.add(times, None, 5126, "SCALAR")
            w.accessors[t_acc]["min"] = [float(times.min())]
            w.accessors[t_acc]["max"] = [float(times.max())]
            v_acc = w.add(vals.reshape(-1, comps), None, 5126, type_str)
            samplers.append({"input": t_acc, "output": v_acc,
                             "interpolation": ch["interp"]})
            channels.append({"sampler": len(samplers) - 1,
                             "target": {"node": int(ch["node"]),
                                        "path": ch["path"]}})
        anims.append({"name": ad.name, "samplers": samplers,
                      "channels": channels})
    if anims:
        doc["animations"] = anims

    skins = []
    for sk in scene.skins:
        ibm = sk.inverse_bind.transpose(0, 2, 1).reshape(-1, 16)
        entry = {"joints": [int(j) for j in sk.joints],
                 "inverseBindMatrices": w.add(ibm, None, 5126, "MAT4")}
        if sk.skeleton is not None:
            entry["skeleton"] = int(sk.skeleton)
        skins.append(entry)
    if skins:
        doc["skins"] = skins

    doc["bufferViews"] = w.views
    doc["accessors"] = w.accessors
    doc["buffers"] = [{"uri": bin_name, "byteLength": len(w.blob)}]

    with open(os.path.join(os.path.dirname(path) or ".", bin_name),
              "wb") as f:
        f.write(bytes(w.blob))
    with open(path, "w") as f:
        json.dump(doc, f)
