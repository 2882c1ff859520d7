"""glTF 2.0 importer (copy of granite_tpu/scene/gltf.py; reference:
renderer/formats/gltf.{hpp,cpp}, the Parser at gltf.hpp:55-165).

Meshes and accessors (sparse ones too), PBR metallic-roughness and
legacy spec-gloss materials, KHR_materials_emissive_strength,
KHR_lights_punctual, cameras, skins, morph targets, animations (LINEAR,
STEP, CUBICSPLINE), GLB containers and data URIs.  Produces a SceneInfo
with numpy SoA buffers ready for pack_scene; images decode through PIL.
tests/test_torch_scene_files.py holds it equal to the original.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Optional

import numpy as np

from ..utils.logging import LOGW
from .scene_formats import (
    ALPHA_MODE_BLEND, ALPHA_MODE_MASK, ALPHA_MODE_OPAQUE,
    LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT,
    AnimationData, CameraData, LightData, MaterialData, MeshData, NodeData,
    SceneInfo, SkinData,
)

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


class GLTFParser:
    def __init__(self, path: str):
        self.base_dir = os.path.dirname(os.path.abspath(path))
        self._bin_chunk: Optional[bytes] = None
        with open(path, "rb") as f:
            head = f.read(4)
            f.seek(0)
            if head == b"glTF":
                self.json = self._parse_glb(f.read())
            else:
                self.json = json.loads(f.read().decode("utf-8"))
        self._buffers: dict[int, np.ndarray] = {}
        self.scene = SceneInfo()
        self._parse()

    # -- containers -----------------------------------------------------------
    def _parse_glb(self, data: bytes) -> dict:
        magic, _version, _length = struct.unpack_from("<III", data, 0)
        if magic != 0x46546C67:
            raise ValueError("bad GLB magic")
        off = 12
        doc = None
        while off < len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            off += 8
            chunk = data[off:off + clen]
            off += clen
            if ctype == 0x4E4F534A:        # 'JSON'
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:      # 'BIN'
                self._bin_chunk = chunk
        if doc is None:
            raise ValueError("GLB missing JSON chunk")
        return doc

    def _buffer(self, index: int) -> np.ndarray:
        if index in self._buffers:
            return self._buffers[index]
        buf = self.json["buffers"][index]
        uri = buf.get("uri")
        if uri is None:
            raw = self._bin_chunk
        elif uri.startswith("data:"):
            raw = base64.b64decode(uri.split(",", 1)[1])
        else:
            from urllib.parse import unquote
            with open(os.path.join(self.base_dir, unquote(uri)), "rb") as f:
                raw = f.read()
        arr = np.frombuffer(raw, dtype=np.uint8)[:buf["byteLength"]]
        self._buffers[index] = arr
        return arr

    def _accessor(self, index: int) -> np.ndarray:
        """Decode accessor -> (count, comps) array; normalized ints -> f32."""
        acc = self.json["accessors"][index]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        comps = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        itemsize = np.dtype(dtype).itemsize
        if "bufferView" in acc:
            bv = self.json["bufferViews"][acc["bufferView"]]
            raw = self._buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", 0) or comps * itemsize
            if stride == comps * itemsize:
                flat = np.frombuffer(
                    raw[start:start + count * stride].tobytes(), dtype=dtype,
                    count=count * comps)
                out = flat.reshape(count, comps)
            else:  # interleaved
                bytes_ = np.lib.stride_tricks.as_strided(
                    raw[start:], shape=(count, comps * itemsize),
                    strides=(stride, 1))
                out = np.frombuffer(bytes_.tobytes(), dtype=dtype).reshape(
                    count, comps)
        else:
            out = np.zeros((count, comps), dtype)
        if "sparse" in acc:
            sp = acc["sparse"]
            n = sp["count"]
            idt = _COMPONENT_DTYPES[sp["indices"]["componentType"]]
            ibv = self.json["bufferViews"][sp["indices"]["bufferView"]]
            iraw = self._buffer(ibv["buffer"])
            ioff = ibv.get("byteOffset", 0) + sp["indices"].get(
                "byteOffset", 0)
            sidx = np.frombuffer(
                iraw[ioff:ioff + n * np.dtype(idt).itemsize].tobytes(),
                dtype=idt)
            vbv = self.json["bufferViews"][sp["values"]["bufferView"]]
            vraw = self._buffer(vbv["buffer"])
            voff = vbv.get("byteOffset", 0) + sp["values"].get(
                "byteOffset", 0)
            svals = np.frombuffer(
                vraw[voff:voff + n * comps * itemsize].tobytes(),
                dtype=dtype).reshape(n, comps)
            out = out.copy()
            out[sidx] = svals
        if acc.get("normalized"):
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
            if info.min < 0:
                out = np.maximum(out, -1.0)
        return out

    # -- document -------------------------------------------------------------
    def _parse(self) -> None:
        s = self.scene
        doc = self.json

        for img in doc.get("images", []):
            s.images.append(self._load_image(img))
            s.image_srgb.append(False)  # set per-use below
            if "uri" in img and not img["uri"].startswith("data:"):
                from urllib.parse import unquote
                s.image_paths.append(os.path.join(
                    self.base_dir, unquote(img["uri"])))
            else:
                s.image_paths.append(None)

        tex_to_img = [t.get("source", -1) for t in doc.get("textures", [])]

        def img_of(tex_info) -> Optional[int]:
            if tex_info is None:
                return None
            t = tex_info.get("index")
            if t is None or t >= len(tex_to_img):
                return None
            i = tex_to_img[t]
            return i if i >= 0 else None

        for m in doc.get("materials", []):
            mat = MaterialData(name=m.get("name", ""))
            pbr = m.get("pbrMetallicRoughness", {})
            mat.base_color_factor = np.asarray(
                pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
            mat.metallic_factor = pbr.get("metallicFactor", 1.0)
            mat.roughness_factor = pbr.get("roughnessFactor", 1.0)
            mat.base_color_image = img_of(pbr.get("baseColorTexture"))
            mat.metallic_roughness_image = img_of(
                pbr.get("metallicRoughnessTexture"))
            mat.normal_image = img_of(m.get("normalTexture"))
            if m.get("normalTexture"):
                mat.normal_scale = m["normalTexture"].get("scale", 1.0)
            mat.occlusion_image = img_of(m.get("occlusionTexture"))
            mat.emissive_image = img_of(m.get("emissiveTexture"))
            mat.emissive_factor = np.asarray(
                m.get("emissiveFactor", [0, 0, 0]), np.float32)
            strength = m.get("extensions", {}).get(
                "KHR_materials_emissive_strength", {})
            mat.emissive_factor = mat.emissive_factor * strength.get(
                "emissiveStrength", 1.0)
            # Legacy specular-glossiness materials map onto metallic-
            # roughness exactly like the reference (gltf.cpp:945-983):
            # diffuse -> base color, 1-gloss -> roughness, max(spec) ->
            # metallic; the specularGlossinessTexture is unsupported
            # there too.
            sg = m.get("extensions", {}).get(
                "KHR_materials_pbrSpecularGlossiness")
            if sg is not None:
                if "diffuseFactor" in sg:
                    mat.base_color_factor = np.asarray(
                        sg["diffuseFactor"], np.float32)
                if "glossinessFactor" in sg:
                    mat.roughness_factor = float(np.clip(
                        1.0 - sg["glossinessFactor"], 0.0, 1.0))
                if "specularFactor" in sg:
                    mat.metallic_factor = float(
                        np.max(sg["specularFactor"][:3]))
                if "diffuseTexture" in sg:
                    mat.base_color_image = img_of(sg["diffuseTexture"])
                if "specularGlossinessTexture" in sg:
                    LOGW("specularGlossinessTexture unsupported; "
                         "use pbrMetallicRoughness (gltf.cpp:980)")
            mode = m.get("alphaMode", "OPAQUE")
            mat.alpha_mode = {"OPAQUE": ALPHA_MODE_OPAQUE,
                              "MASK": ALPHA_MODE_MASK,
                              "BLEND": ALPHA_MODE_BLEND}[mode]
            mat.alpha_cutoff = m.get("alphaCutoff", 0.5)
            mat.two_sided = m.get("doubleSided", False)
            # Color/emissive textures are sRGB-encoded (gltf spec).
            for im in (mat.base_color_image, mat.emissive_image):
                if im is not None:
                    s.image_srgb[im] = True
            s.materials.append(mat)

        # meshes: each glTF mesh is a list of primitives; node.meshes
        # references flattened primitive indices (the reference does the
        # same flattening, gltf.cpp mesh parsing).
        mesh_prim_lists: list[list[int]] = []
        for mesh in doc.get("meshes", []):
            prims = []
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:
                    LOGW("skipping non-triangle primitive (mode=%d)",
                         prim.get("mode", 4))
                    continue
                attrs = prim["attributes"]
                md = MeshData()
                md.positions = self._accessor(
                    attrs["POSITION"]).astype(np.float32)
                if "NORMAL" in attrs:
                    md.normals = self._accessor(
                        attrs["NORMAL"]).astype(np.float32)
                if "TEXCOORD_0" in attrs:
                    md.uvs = self._accessor(
                        attrs["TEXCOORD_0"]).astype(np.float32)
                if "TANGENT" in attrs:
                    md.tangents = self._accessor(
                        attrs["TANGENT"]).astype(np.float32)
                if "COLOR_0" in attrs:
                    c = self._accessor(attrs["COLOR_0"]).astype(np.float32)
                    if c.shape[1] == 3:
                        c = np.concatenate(
                            [c, np.ones((len(c), 1), np.float32)], axis=1)
                    md.colors = c
                if "JOINTS_0" in attrs:
                    md.joints = self._accessor(attrs["JOINTS_0"]).astype(
                        np.int32)
                if "WEIGHTS_0" in attrs:
                    md.weights = self._accessor(attrs["WEIGHTS_0"]).astype(
                        np.float32)
                if "indices" in prim:
                    md.indices = self._accessor(
                        prim["indices"]).reshape(-1)[::1].astype(
                            np.int32).reshape(-1, 3)
                md.material = prim.get("material", -1)
                targets = prim.get("targets")
                if targets:
                    # Morph targets (scene_formats.hpp weights channel).
                    md.morph_position_deltas = [
                        self._accessor(t["POSITION"]).astype(np.float32)
                        if "POSITION" in t
                        else np.zeros_like(md.positions)
                        for t in targets]
                    if any("NORMAL" in t for t in targets):
                        md.morph_normal_deltas = [
                            self._accessor(t["NORMAL"]).astype(np.float32)
                            if "NORMAL" in t
                            else np.zeros((len(md.positions), 3),
                                          np.float32)
                            for t in targets]
                    w = mesh.get("weights")
                    md.default_morph_weights = (
                        np.asarray(w, np.float32) if w is not None
                        else np.zeros(len(targets), np.float32))
                md.finalize()
                prims.append(len(s.meshes))
                s.meshes.append(md)
            mesh_prim_lists.append(prims)

        for c in doc.get("cameras", []):
            cam = CameraData(name=c.get("name", ""))
            if c.get("type") == "perspective":
                p = c.get("perspective", {})
                cam.fovy = p.get("yfov", 1.0)
                cam.aspect = p.get("aspectRatio", 16 / 9)
                cam.znear = p.get("znear", 0.1)
                cam.zfar = p.get("zfar", 1000.0)
            elif c.get("type") == "orthographic":
                o = c.get("orthographic", {})
                cam.ortho = True
                cam.xmag = o.get("xmag", 1.0)
                cam.ymag = o.get("ymag", 1.0)
                cam.znear = o.get("znear", 0.1)
                cam.zfar = o.get("zfar", 1000.0)
            s.cameras.append(cam)

        for l in doc.get("extensions", {}).get(
                "KHR_lights_punctual", {}).get("lights", []):
            light = LightData()
            light.type = {"directional": LIGHT_DIRECTIONAL,
                          "point": LIGHT_POINT,
                          "spot": LIGHT_SPOT}[l.get("type", "directional")]
            light.color = np.asarray(l.get("color", [1, 1, 1]), np.float32)
            light.intensity = l.get("intensity", 1.0)
            light.range = l.get("range", 0.0)
            spot = l.get("spot", {})
            light.inner_cone = spot.get("innerConeAngle", 0.0)
            light.outer_cone = spot.get("outerConeAngle", np.pi / 4)
            s.lights.append(light)

        for n in doc.get("nodes", []):
            nd = NodeData(name=n.get("name", ""))
            nd.children = list(n.get("children", []))
            if "matrix" in n:
                m = np.asarray(n["matrix"], np.float32).reshape(4, 4).T
                from ..math.transforms import decompose_trs
                nd.translation, nd.rotation, nd.scale = decompose_trs(m)
            else:
                nd.translation = np.asarray(
                    n.get("translation", [0, 0, 0]), np.float32)
                r = n.get("rotation", [0, 0, 0, 1])    # gltf: (x, y, z, w)
                nd.rotation = np.asarray([r[3], r[0], r[1], r[2]], np.float32)
                nd.scale = np.asarray(n.get("scale", [1, 1, 1]), np.float32)
            if "mesh" in n:
                nd.meshes = list(mesh_prim_lists[n["mesh"]])
            if "camera" in n:
                nd.camera = n["camera"]
                if n["camera"] < len(s.cameras):
                    s.cameras[n["camera"]].node = len(s.nodes)
            ext = n.get("extensions", {}).get("KHR_lights_punctual", {})
            if "light" in ext:
                nd.light = ext["light"]
            if "skin" in n:
                nd.skin = n["skin"]
            if "weights" in n:
                nd.morph_weights = np.asarray(n["weights"], np.float32)
            s.nodes.append(nd)

        scene_idx = doc.get("scene", 0)
        scenes = doc.get("scenes", [])
        if scenes:
            s.roots = list(scenes[scene_idx].get("nodes", []))
        else:
            s.roots = list(range(len(s.nodes)))

        for a in doc.get("animations", []):
            ad = AnimationData(name=a.get("name", ""))
            samplers = a.get("samplers", [])
            for ch in a.get("channels", []):
                sam = samplers[ch["sampler"]]
                tgt = ch.get("target", {})
                if "node" not in tgt:
                    continue
                times = self._accessor(sam["input"]).reshape(-1).astype(
                    np.float32)
                vals = self._accessor(sam["output"]).astype(np.float32)
                interp = sam.get("interpolation", "LINEAR")
                path = tgt["path"]
                if path == "rotation":
                    # gltf quats are (x,y,z,w); ours are (w,x,y,z).
                    if interp == "CUBICSPLINE":
                        vals = vals.reshape(len(times), 3, 4)
                        vals = vals[..., [3, 0, 1, 2]]
                    else:
                        vals = vals[:, [3, 0, 1, 2]]
                elif interp == "CUBICSPLINE":
                    vals = vals.reshape(len(times), 3, -1)
                elif path == "weights":
                    # Morph weights: SCALAR stream of K*T values.
                    vals = vals.reshape(len(times), -1)
                ad.channels.append(dict(node=tgt["node"], path=path,
                                        interp=interp, times=times,
                                        values=vals))
            s.animations.append(ad)

        for sk in doc.get("skins", []):
            sd = SkinData()
            sd.joints = np.asarray(sk.get("joints", []), np.int32)
            if "inverseBindMatrices" in sk:
                ibm = self._accessor(sk["inverseBindMatrices"])
                # column-major storage -> transpose to math convention
                sd.inverse_bind = ibm.reshape(-1, 4, 4).transpose(0, 2, 1) \
                    .astype(np.float32)
            else:
                sd.inverse_bind = np.tile(np.eye(4, dtype=np.float32),
                                          (len(sd.joints), 1, 1))
            sd.skeleton = sk.get("skeleton")
            s.skins.append(sd)

    def _load_image(self, img: dict) -> np.ndarray:
        from io import BytesIO
        from PIL import Image
        if "uri" in img and not img["uri"].startswith("data:"):
            from urllib.parse import unquote
            path = os.path.join(self.base_dir, unquote(img["uri"]))
            pil = Image.open(path)
        else:
            if "uri" in img:
                raw = base64.b64decode(img["uri"].split(",", 1)[1])
            else:
                bv = self.json["bufferViews"][img["bufferView"]]
                buf = self._buffer(bv["buffer"])
                off = bv.get("byteOffset", 0)
                raw = buf[off:off + bv["byteLength"]].tobytes()
            pil = Image.open(BytesIO(raw))
        if pil.mode != "RGBA":
            pil = pil.convert("RGBA")
        return np.asarray(pil, dtype=np.uint8)

    def get_scene(self) -> SceneInfo:
        return self.scene
