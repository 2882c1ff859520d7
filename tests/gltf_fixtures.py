"""glTF fixtures for the scene-file tests and chip_smoke.py: a procedural
skinned character, a morph-target sheet, a camera node added to an
exported scene, and the `.scene` composition of them.  numpy and json
only (no jax, no torch), like golden_utils.py, so the card's smoke run
and the CPU tests write the same files.

character.gltf: 16 limbs radiating from a root joint, each a tube of
LIMB_SEGMENTS segments x LIMB_SIDES sides (24,576 triangles in all)
skinned to a chain of 4 joints (65 joints with the root); every vertex
is weighted to 2 joints through JOINTS_0 / WEIGHTS_0.  Its ANIM_SECONDS
animation swings every limb joint (LINEAR rotations), bobs the root
(CUBICSPLINE translation) and pulses one joint's scale (STEP).

morph.gltf: a SHEET_QUADS^2-quad sheet (8,192 triangles) with 4 position
and normal morph targets (bumps) and a LINEAR `weights` channel.

to_glb and to_data_uris rewrite a .gltf (with its .bin and image files)
as a GLB container, images in its binary chunk, or as one .gltf whose
buffers and images are base64 data URIs.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

LIMBS, JOINTS_PER_LIMB = 16, 4
LIMB_SEGMENTS, LIMB_SIDES = 32, 24
LIMB_LENGTH, LIMB_RADIUS, LIMB_BASE = 1.2, 0.12, 0.15
SHEET_QUADS, SHEET_SIZE, MORPH_TARGETS = 64, 4.0, 4
ANIM_SECONDS = 2.0
CHARACTER_TRIANGLES = LIMBS * LIMB_SEGMENTS * LIMB_SIDES * 2
SHEET_TRIANGLES = SHEET_QUADS * SHEET_QUADS * 2

_FLOAT, _USHORT, _UINT = 5126, 5123, 5125
_TYPES = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}


class _Doc:
    """A glTF document and its one binary buffer."""

    def __init__(self):
        self.blob = bytearray()
        self.doc = {"asset": {"version": "2.0",
                              "generator": "tests/gltf_fixtures.py"},
                    "bufferViews": [], "accessors": []}

    def accessor(self, arr: np.ndarray, comp: int = _FLOAT,
                 minmax: bool = False) -> int:
        arr = np.ascontiguousarray(arr)
        arr2 = arr.reshape(len(arr), -1)
        self.blob += b"\0" * ((-len(self.blob)) % 4)
        self.doc["bufferViews"].append({
            "buffer": 0, "byteOffset": len(self.blob),
            "byteLength": arr.nbytes})
        self.blob += arr.tobytes()
        acc = {"bufferView": len(self.doc["bufferViews"]) - 1,
               "componentType": comp, "count": int(len(arr)),
               "type": _TYPES[arr2.shape[1]]}
        if minmax:
            acc["min"] = [float(x) for x in arr2.min(axis=0)]
            acc["max"] = [float(x) for x in arr2.max(axis=0)]
        self.doc["accessors"].append(acc)
        return len(self.doc["accessors"]) - 1

    def write(self, path: str) -> None:
        bin_name = os.path.splitext(os.path.basename(path))[0] + ".bin"
        self.doc["buffers"] = [{"uri": bin_name,
                                "byteLength": len(self.blob)}]
        with open(os.path.join(os.path.dirname(path), bin_name), "wb") as f:
            f.write(bytes(self.blob))
        with open(path, "w") as f:
            json.dump(self.doc, f)


def _quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), glTF's order."""
    t = np.trace(m)
    if t > 0:
        s = 2.0 * np.sqrt(t + 1.0)
        q = [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s, 0.25 * s]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = [0.0] * 4
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        q[3] = (m[k, j] - m[j, k]) / s
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion product a * b."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz])


def _axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])


def _rotation_to(d: np.ndarray) -> np.ndarray:
    """The rotation matrix taking +y to the unit vector d."""
    y = np.array([0.0, 1.0, 0.0])
    v = np.cross(y, d)
    c = float(np.dot(y, d))
    if np.linalg.norm(v) < 1e-9:
        return np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


def _limb_directions() -> np.ndarray:
    """LIMBS unit vectors on a golden-angle spiral over the upper 3/4 of
    the sphere."""
    k = np.arange(LIMBS) + 0.5
    y = 1.0 - 1.5 * k / LIMBS
    r = np.sqrt(1.0 - y * y)
    phi = k * np.pi * (3.0 - np.sqrt(5.0))
    return np.stack([r * np.cos(phi), y, r * np.sin(phi)], 1)


def write_character(path: str) -> None:
    """The skinned character (see the module docstring)."""
    g = _Doc()
    dirs = _limb_directions()
    seg_len = LIMB_LENGTH / JOINTS_PER_LIMB
    nodes = [{"name": "root", "children": []}]
    joints_world = [np.eye(4)]
    pos_l, nrm_l, jnt_l, wgt_l, idx_l = [], [], [], [], []
    ring = np.arange(LIMB_SIDES) * 2 * np.pi / LIMB_SIDES
    for limb, d in enumerate(dirs):
        rot = _rotation_to(d)
        first = len(nodes)
        for j in range(JOINTS_PER_LIMB):
            node = {"name": f"limb{limb}_{j}",
                    "translation": ([float(x) for x in d * LIMB_BASE]
                                    if j == 0 else [0.0, seg_len, 0.0])}
            if j == 0:
                node["rotation"] = [float(x) for x in _quat_from_matrix(rot)]
                nodes[0]["children"].append(first)
            if j < JOINTS_PER_LIMB - 1:
                node["children"] = [first + j + 1]
            nodes.append(node)
            w = np.eye(4)
            w[:3, :3] = rot
            w[:3, 3] = d * (LIMB_BASE + j * seg_len)
            joints_world.append(w)
        # the tube along d, radius tapering to half at the tip
        t = np.arange(LIMB_SEGMENTS + 1) / LIMB_SEGMENTS
        radius = LIMB_RADIUS * (1.0 - 0.5 * t)
        ring_n = np.stack([np.cos(ring), np.zeros_like(ring),
                           np.sin(ring)], 1)            # limb space
        local = (ring_n[None] * radius[:, None, None]
                 + np.stack([np.zeros_like(t), LIMB_BASE + t * LIMB_LENGTH,
                             np.zeros_like(t)], 1)[:, None])
        pos_l.append((local.reshape(-1, 3) @ rot.T).astype(np.float32))
        nrm_l.append(np.broadcast_to(ring_n @ rot.T, local.shape)
                     .reshape(-1, 3).astype(np.float32))
        # two joints a vertex: the chain joints either side of it
        u = np.clip(t * JOINTS_PER_LIMB - 0.5, 0, JOINTS_PER_LIMB - 1)
        a = np.minimum(np.floor(u), JOINTS_PER_LIMB - 2).astype(int)
        f = u - a
        jn = np.stack([first + a, first + a + 1, np.zeros_like(a),
                       np.zeros_like(a)], 1)
        wt = np.stack([1.0 - f, f, np.zeros_like(f), np.zeros_like(f)], 1)
        jnt_l.append(np.repeat(jn, LIMB_SIDES, 0).astype(np.uint16))
        wgt_l.append(np.repeat(wt, LIMB_SIDES, 0).astype(np.float32))
        r0 = np.arange(LIMB_SEGMENTS)[:, None] * LIMB_SIDES
        s0 = np.arange(LIMB_SIDES)[None]
        s1 = (s0 + 1) % LIMB_SIDES
        base = limb * (LIMB_SEGMENTS + 1) * LIMB_SIDES
        a0, b0 = r0 + s0, r0 + s1
        a1, b1 = a0 + LIMB_SIDES, b0 + LIMB_SIDES
        quads = np.stack([a0, a1, b0, b0, a1, b1], -1).reshape(-1, 3)
        idx_l.append((quads + base).astype(np.uint32))
    pos = np.concatenate(pos_l)
    mesh_node = len(nodes)
    nodes.append({"name": "character", "mesh": 0, "skin": 0})
    g.doc["nodes"] = nodes
    g.doc["scenes"] = [{"nodes": [0, mesh_node]}]
    g.doc["scene"] = 0
    g.doc["materials"] = [{"name": "character", "pbrMetallicRoughness": {
        "baseColorFactor": [0.85, 0.35, 0.2, 1.0], "metallicFactor": 0.0,
        "roughnessFactor": 0.5}}]
    attrs = {"POSITION": g.accessor(pos, minmax=True),
             "NORMAL": g.accessor(np.concatenate(nrm_l)),
             "JOINTS_0": g.accessor(np.concatenate(jnt_l), _USHORT),
             "WEIGHTS_0": g.accessor(np.concatenate(wgt_l))}
    g.doc["meshes"] = [{"primitives": [{
        "attributes": attrs, "material": 0,
        "indices": g.accessor(np.concatenate(idx_l).reshape(-1), _UINT)}]}]
    ibm = np.stack([np.linalg.inv(w).T for w in joints_world])
    g.doc["skins"] = [{"joints": list(range(len(joints_world))),
                       "skeleton": 0,
                       "inverseBindMatrices": g.accessor(
                           ibm.reshape(-1, 16).astype(np.float32))}]
    g.doc["animations"] = [_character_animation(g, nodes)]
    g.write(path)


def _character_animation(g: _Doc, nodes: list) -> dict:
    samplers, channels = [], []

    def channel(node, path, interp, times, values):
        samplers.append({"input": g.accessor(
            np.asarray(times, np.float32)[:, None], minmax=True),
            "output": g.accessor(np.asarray(values, np.float32)),
            "interpolation": interp})
        channels.append({"sampler": len(samplers) - 1,
                         "target": {"node": node, "path": path}})

    times = np.linspace(0.0, ANIM_SECONDS, 5)
    for n in range(1, len(nodes) - 1):
        limb, j = divmod(n - 1, JOINTS_PER_LIMB)
        rest = np.asarray(nodes[n].get("rotation", [0, 0, 0, 1]))
        axis = [np.cos(limb), 0.0, np.sin(limb)]
        swing = 0.45 * np.sin(2 * np.pi * times / ANIM_SECONDS
                              + 0.7 * limb + 0.4 * j)
        channel(n, "rotation", "LINEAR", times,
                [_quat_mul(rest, _axis_angle(axis, a)) for a in swing])
    # root bob: (in-tangent, value, out-tangent) a key
    keys = np.array([0.0, 1.0, 2.0]) * ANIM_SECONDS / 2
    bob = np.array([[0, 0, 0], [0, 0.35, 0], [0, 0, 0]], np.float32)
    tan = np.array([[0, 0.6, 0], [0, 0, 0], [0, -0.6, 0]], np.float32)
    channel(0, "translation", "CUBICSPLINE", keys,
            np.stack([tan, bob, tan], 1).reshape(-1, 3))
    channel(JOINTS_PER_LIMB, "scale", "STEP", times,
            [[1, 1, 1], [1.6, 1.6, 1.6]] * 2 + [[1, 1, 1]])
    return {"name": "wave", "samplers": samplers, "channels": channels}


def write_morph_sheet(path: str) -> None:
    """The morph-target sheet (see the module docstring)."""
    g = _Doc()
    n = SHEET_QUADS + 1
    lin = (np.arange(n) / SHEET_QUADS - 0.5) * SHEET_SIZE
    xx, zz = np.meshgrid(lin, lin)
    pos = np.stack([xx, np.zeros_like(xx), zz], -1).reshape(-1, 3)
    r0 = np.arange(SHEET_QUADS)[:, None] * n
    c0 = np.arange(SHEET_QUADS)[None]
    a0 = r0 + c0
    quads = np.stack([a0, a0 + n, a0 + 1, a0 + 1, a0 + n, a0 + n + 1],
                     -1).reshape(-1).astype(np.uint32)
    targets = []
    for k in range(MORPH_TARGETS):
        cx, cz = 0.25 * SHEET_SIZE * np.array(
            [np.cos(k * np.pi / 2), np.sin(k * np.pi / 2)])
        d2 = (pos[:, 0] - cx) ** 2 + (pos[:, 2] - cz) ** 2
        h = 0.6 * np.exp(-d2 / 0.5)
        dp = np.zeros_like(pos)
        dp[:, 1] = h
        # the bump's normal minus the flat normal (0, 1, 0)
        gx, gz = h * -2 * (pos[:, 0] - cx) / 0.5, h * -2 * (pos[:, 2] - cz) / 0.5
        nb = np.stack([-gx, np.ones_like(gx), -gz], 1)
        nb /= np.linalg.norm(nb, axis=1, keepdims=True)
        targets.append({
            "POSITION": g.accessor(dp.astype(np.float32), minmax=True),
            "NORMAL": g.accessor((nb - [0, 1, 0]).astype(np.float32))})
    attrs = {"POSITION": g.accessor(pos.astype(np.float32), minmax=True),
             "NORMAL": g.accessor(np.tile(np.float32([0, 1, 0]),
                                          (len(pos), 1))),
             "TEXCOORD_0": g.accessor(
                 (pos[:, [0, 2]] / SHEET_SIZE + 0.5).astype(np.float32))}
    g.doc["materials"] = [{"name": "sheet", "doubleSided": True,
                           "pbrMetallicRoughness": {
                               "baseColorFactor": [0.25, 0.55, 0.85, 1.0],
                               "metallicFactor": 0.0,
                               "roughnessFactor": 0.4}}]
    g.doc["meshes"] = [{"weights": [0.0] * MORPH_TARGETS, "primitives": [{
        "attributes": attrs, "targets": targets, "material": 0,
        "indices": g.accessor(quads, _UINT)}]}]
    g.doc["nodes"] = [{"name": "sheet", "mesh": 0}]
    g.doc["scenes"] = [{"nodes": [0]}]
    g.doc["scene"] = 0
    times = np.linspace(0.0, ANIM_SECONDS, 5)
    weights = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                        [0, 0, 0, 1], [1, 0, 0, 0]], np.float32)
    g.doc["animations"] = [{"name": "bumps", "samplers": [{
        "input": g.accessor(times.astype(np.float32)[:, None], minmax=True),
        "output": g.accessor(weights.reshape(-1, 1)),
        "interpolation": "LINEAR"}], "channels": [{
            "sampler": 0, "target": {"node": 0, "path": "weights"}}]}]
    g.write(path)


def add_camera(gltf_path: str, eye, target, yfov: float = 0.9,
               aspect: float = 16 / 9, znear: float = 0.1,
               zfar: float = 200.0) -> None:
    """Append a perspective camera node at `eye` looking at `target` (+y
    up) to an exported .gltf and to its scene's roots, as camera 0 when
    the file has none."""
    with open(gltf_path) as f:
        doc = json.load(f)
    eye = np.asarray(eye, np.float64)
    back = eye - np.asarray(target, np.float64)
    back /= np.linalg.norm(back)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    rot = _quat_from_matrix(np.stack([right, up, back], 1))
    doc.setdefault("cameras", []).append({
        "type": "perspective", "perspective": {
            "yfov": yfov, "aspectRatio": aspect, "znear": znear,
            "zfar": zfar}})
    doc["nodes"].append({"name": "camera",
                         "camera": len(doc["cameras"]) - 1,
                         "translation": [float(x) for x in eye],
                         "rotation": [float(x) for x in rot]})
    doc["scenes"][doc.get("scene", 0)]["nodes"].append(len(doc["nodes"]) - 1)
    with open(gltf_path, "w") as f:
        json.dump(doc, f)


def write_scene(path: str, base: str, characters, sheet) -> None:
    """A `.scene` composition: the glTF `base` (a path relative to the
    .scene's directory) once, character.gltf at each translation of
    `characters` and morph.gltf at `sheet`, both written beside it."""
    d = os.path.dirname(path)
    write_character(os.path.join(d, "character.gltf"))
    write_morph_sheet(os.path.join(d, "morph.gltf"))
    doc = {"scenes": [
        {"path": base},
        {"path": "character.gltf",
         "instances": [{"translation": [float(x) for x in t]}
                       for t in characters]},
        {"path": "morph.gltf",
         "instances": [{"translation": [float(x) for x in sheet]}]}]}
    with open(path, "w") as f:
        json.dump(doc, f)


def _load_with_payloads(gltf_path: str):
    """(document, the buffer's bytes, each image's file bytes)."""
    d = os.path.dirname(gltf_path)
    with open(gltf_path) as f:
        doc = json.load(f)
    (buf,) = doc["buffers"]
    with open(os.path.join(d, buf["uri"]), "rb") as f:
        blob = f.read()
    images = []
    for img in doc.get("images", []):
        with open(os.path.join(d, img["uri"]), "rb") as f:
            images.append(f.read())
    return doc, blob, images


def to_glb(gltf_path: str, glb_path: str) -> None:
    """The .gltf as a GLB: JSON chunk, then one BIN chunk that holds the
    buffer and, after it, each image as a bufferView with a mimeType."""
    doc, blob, images = _load_with_payloads(gltf_path)
    blob = bytearray(blob)
    for img, data in zip(doc.get("images", []), images):
        blob += b"\0" * ((-len(blob)) % 4)
        doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob),
                                   "byteLength": len(data)})
        blob += data
        del img["uri"]
        img["bufferView"] = len(doc["bufferViews"]) - 1
        img["mimeType"] = "image/png"
    blob += b"\0" * ((-len(blob)) % 4)
    doc["buffers"] = [{"byteLength": len(blob)}]
    js = json.dumps(doc).encode("utf-8")
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    with open(glb_path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))


def to_data_uris(gltf_path: str, out_path: str) -> None:
    """The .gltf with its buffer and images inlined as base64 data URIs."""
    doc, blob, images = _load_with_payloads(gltf_path)
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(blob).decode("ascii"))
    for img, data in zip(doc.get("images", []), images):
        img["uri"] = ("data:image/png;base64,"
                      + base64.b64encode(data).decode("ascii"))
    with open(out_path, "w") as f:
        json.dump(doc, f)
