"""Wavefront OBJ -> glTF 2.0 converter (port of tools/obj_to_gltf.py;
reference: tools/obj_to_gltf.cpp).

Supports v/vn/vt/f (triangles + fans), usemtl/mtllib with Kd/Ks/Ns/d and
map_Kd, negative indices, and per-face-vertex index triplets (positions,
uvs, normals deduplicated into unified vertices).

  python -m granite_tpu_torch.tools.obj_to_gltf input.obj output.gltf
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..scene.scene_formats import MaterialData, MeshData, NodeData, SceneInfo
from ..scene_export import export_gltf


def parse_mtl(path: str) -> dict:
    mats: dict = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = {"Kd": (1, 1, 1), "d": 1.0, "Ns": 32.0,
                       "map_Kd": None}
                mats[parts[1]] = cur
            elif cur is None:
                continue
            elif parts[0] == "Kd":
                cur["Kd"] = tuple(float(x) for x in parts[1:4])
            elif parts[0] == "d":
                cur["d"] = float(parts[1])
            elif parts[0] == "Ns":
                cur["Ns"] = float(parts[1])
            elif parts[0] == "map_Kd":
                cur["map_Kd"] = parts[-1]
    return mats


def _resolve(tok: str, nv: int, nvt: int, nvn: int):
    """An OBJ face corner v[/vt[/vn]] (1-based, negative from the end)
    -> 0-based (vi, ti or None, ni or None)."""
    comp = (tok.split("/") + ["", ""])[:3]
    vi = int(comp[0])
    vi = vi - 1 if vi > 0 else nv + vi
    ti = None
    if comp[1]:
        t = int(comp[1])
        ti = t - 1 if t > 0 else nvt + t
    ni = None
    if comp[2]:
        n = int(comp[2])
        ni = n - 1 if n > 0 else nvn + n
    return vi, ti, ni


def load_obj(path: str) -> SceneInfo:
    """-> SceneInfo with one mesh per material group."""
    base = os.path.dirname(os.path.abspath(path))
    vs: list = []
    vts: list = []
    vns: list = []
    mtls: dict = {}
    groups: dict = {}            # material name -> list of face triplets
    cur_mtl = ""

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                vts.append([float(parts[1]), 1.0 - float(parts[2])])
            elif tag == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif tag == "mtllib":
                mtls.update(parse_mtl(os.path.join(base, parts[1])))
            elif tag == "usemtl":
                cur_mtl = parts[1]
            elif tag == "f":
                corners = parts[1:]
                tris = [(corners[0], corners[i], corners[i + 1])
                        for i in range(1, len(corners) - 1)]  # fan
                groups.setdefault(cur_mtl, []).extend(tris)

    info = SceneInfo()
    vs_np = np.asarray(vs, np.float32)
    vts_np = np.asarray(vts, np.float32) if vts else None
    vns_np = np.asarray(vns, np.float32) if vns else None

    root = NodeData(name=os.path.basename(path))
    info.nodes.append(root)
    info.roots = [0]
    for mname, faces in groups.items():
        mat = mtls.get(mname, {})
        m = MaterialData(name=mname or "default")
        kd = mat.get("Kd", (1, 1, 1))
        m.base_color_factor = np.asarray(
            [kd[0], kd[1], kd[2], mat.get("d", 1.0)], np.float32)
        ns = mat.get("Ns", 32.0)
        m.roughness_factor = float(np.clip(
            np.sqrt(2.0 / (ns + 2.0)), 0.04, 1.0))
        m.metallic_factor = 0.0
        if mat.get("map_Kd"):
            img_path = os.path.join(base, mat["map_Kd"])
            if os.path.exists(img_path):
                from PIL import Image
                pil = Image.open(img_path).convert("RGBA")
                info.images.append(np.asarray(pil, np.uint8))
                info.image_srgb.append(True)
                info.image_paths.append(img_path)
                m.base_color_image = len(info.images) - 1
        mat_idx = len(info.materials)
        info.materials.append(m)

        # Deduplicate (v, vt, vn) triplets into unified vertices.
        remap: dict = {}
        pos_l, uv_l, nrm_l, idx_l = [], [], [], []
        for tri in faces:
            tri_idx = []
            for tok in tri:
                if tok not in remap:
                    vi, ti, ni = _resolve(tok, len(vs), len(vts), len(vns))
                    remap[tok] = len(pos_l)
                    pos_l.append(vs_np[vi])
                    uv_l.append(vts_np[ti] if ti is not None
                                and vts_np is not None else (0.0, 0.0))
                    nrm_l.append(vns_np[ni] if ni is not None
                                 and vns_np is not None else None)
                tri_idx.append(remap[tok])
            idx_l.append(tri_idx)
        md = MeshData()
        md.positions = np.asarray(pos_l, np.float32)
        md.uvs = np.asarray(uv_l, np.float32)
        if all(x is not None for x in nrm_l) and nrm_l:
            md.normals = np.asarray(nrm_l, np.float32)
        md.indices = np.asarray(idx_l, np.int32)
        md.material = mat_idx
        md.finalize()
        root.meshes.append(len(info.meshes))
        info.meshes.append(md)
    return info


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 2
    info = load_obj(argv[0])
    export_gltf(info, argv[1])
    print(f"wrote {argv[1]}: {len(info.meshes)} meshes, "
          f"{len(info.materials)} materials")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
