# Frozen copy of granite_tpu_torch/scene/scene_formats.py at commit 757dbb804350, part of the
# benchmark's plain reference (benchmark/gref/README.md); kernel routes
# removed, so every call takes the plain PyTorch version.
"""Intermediate scene structs and mesh processing (copy of the parts of
granite_tpu/scene/scene_formats.py the port uses; reference:
renderer/formats/scene_formats.hpp).

The records keep every field of the original: the glTF parser
(scene/gltf.py) sets them all.  MeshData carries either the classic SoA
arrays or an MLT2 meshlet blob (the port's native codec,
granite_tpu_torch/native), decoded to SoA at instantiation.
tests/test_torch_host_copies.py and tests/test_torch_scene_files.py hold
this copy equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

ALPHA_MODE_OPAQUE = 0
ALPHA_MODE_MASK = 1
ALPHA_MODE_BLEND = 2

LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2


@dataclass
class MaterialData:
    """PBR metallic-roughness record (scene_formats.hpp MaterialInfo)."""
    name: str = ""
    base_color_factor: np.ndarray = field(
        default_factory=lambda: np.ones(4, np.float32))
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    emissive_factor: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    base_color_image: Optional[int] = None       # image index
    metallic_roughness_image: Optional[int] = None
    normal_image: Optional[int] = None
    occlusion_image: Optional[int] = None
    emissive_image: Optional[int] = None
    normal_scale: float = 1.0
    alpha_mode: int = ALPHA_MODE_OPAQUE
    alpha_cutoff: float = 0.5
    two_sided: bool = False


@dataclass
class MeshData:
    """One primitive, SoA numpy arrays (scene_formats.hpp Mesh)."""
    positions: np.ndarray = None                 # (V, 3) f32
    normals: Optional[np.ndarray] = None         # (V, 3)
    uvs: Optional[np.ndarray] = None             # (V, 2)
    tangents: Optional[np.ndarray] = None        # (V, 4) xyz + handedness w
    colors: Optional[np.ndarray] = None          # (V, 4)
    joints: Optional[np.ndarray] = None          # (V, 4) u16
    weights: Optional[np.ndarray] = None         # (V, 4) f32
    # Morph targets: per-target position/normal deltas.
    morph_position_deltas: Optional[list] = None  # [T x (V, 3)]
    morph_normal_deltas: Optional[list] = None    # [T x (V, 3)]
    default_morph_weights: Optional[np.ndarray] = None  # (T,)
    indices: np.ndarray = None                   # (T, 3) i32
    material: int = -1
    aabb_min: np.ndarray = None
    aabb_max: np.ndarray = None
    # MeshEncoding (managers/resource_manager.hpp:85-92): "classic"
    # carries the SoA arrays above; "meshlet" carries an MLT2 blob that
    # pack_scene decodes at instantiation (the MeshletDecoded path).
    encoding: str = "classic"
    meshlet_blob: Optional[bytes] = None
    meshlet_count: int = 0
    meshlet_vertices: int = 0      # decode capacity (duplicated verts)
    meshlet_triangles: int = 0

    def to_meshlets(self) -> "MeshData":
        """Re-encode this mesh as MLT2 meshlet streams, dropping the raw
        arrays.  Material and AABB are kept; normals and UVs ride the
        streams."""
        from ..native import meshlet2_encode
        self.finalize()
        blob, n = meshlet2_encode(self.positions, self.normals, self.uvs,
                                  self.indices)
        out = MeshData(material=self.material,
                       aabb_min=self.aabb_min.copy(),
                       aabb_max=self.aabb_max.copy())
        out.encoding = "meshlet"
        out.meshlet_blob = blob
        out.meshlet_count = n
        # meshlets duplicate shared vertices; bound by 3*T
        out.meshlet_vertices = 3 * len(self.indices)
        out.meshlet_triangles = len(self.indices)
        return out

    def decode_meshlets(self) -> "MeshData":
        """Materialize the SoA arrays from the MLT2 blob in place."""
        from ..native import meshlet2_decode
        if self.encoding != "meshlet" or self.positions is not None:
            return self
        pos, nrm, uv, idx = meshlet2_decode(
            self.meshlet_blob, self.meshlet_count,
            self.meshlet_vertices, self.meshlet_triangles)
        self.positions = pos
        self.normals = nrm
        self.uvs = uv
        self.indices = idx
        return self.finalize()

    def finalize(self) -> "MeshData":
        if self.encoding == "meshlet" and self.positions is None:
            return self.decode_meshlets()
        self.positions = np.ascontiguousarray(self.positions, np.float32)
        if self.indices is None:
            n = len(self.positions)
            self.indices = np.arange(n, dtype=np.int32).reshape(-1, 3)
        self.indices = np.ascontiguousarray(self.indices,
                                            np.int32).reshape(-1, 3)
        self.aabb_min = self.positions.min(axis=0)
        self.aabb_max = self.positions.max(axis=0)
        if self.normals is None:
            self.normals = generate_normals(self.positions, self.indices)
        if self.uvs is None:
            self.uvs = np.zeros((len(self.positions), 2), np.float32)
        if self.tangents is None:
            self.tangents = generate_tangents(self.positions, self.normals,
                                              self.uvs, self.indices)
        return self


@dataclass
class NodeData:
    name: str = ""
    children: list = field(default_factory=list)
    translation: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(                 # (w, x, y, z)
        default_factory=lambda: np.array([1, 0, 0, 0], np.float32))
    scale: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32))
    meshes: list = field(default_factory=list)    # MeshData indices
    camera: Optional[int] = None
    light: Optional[int] = None
    skin: Optional[int] = None
    morph_weights: Optional[np.ndarray] = None    # node weights override


@dataclass
class CameraData:
    name: str = ""
    fovy: float = 1.0
    aspect: float = 16 / 9
    znear: float = 0.1
    zfar: float = 1000.0
    node: Optional[int] = None
    ortho: bool = False
    xmag: float = 1.0
    ymag: float = 1.0


@dataclass
class LightData:
    """KHR_lights_punctual record."""
    type: int = LIGHT_DIRECTIONAL
    color: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32))
    intensity: float = 1.0
    range: float = 0.0
    inner_cone: float = 0.0
    outer_cone: float = np.pi / 4


@dataclass
class AnimationData:
    """Channels sampling node TRS (scene_formats.hpp:54 channel types)."""
    name: str = ""
    # each channel: dict(node=int, path='translation|rotation|scale|weights',
    #                    interp='LINEAR|STEP|CUBICSPLINE',
    #                    times=(K,), values=(K, C) [or (K,3,C) cubic])
    channels: list = field(default_factory=list)

    @property
    def duration(self) -> float:
        return max((float(c["times"][-1]) for c in self.channels
                    if len(c["times"])), default=0.0)


@dataclass
class SkinData:
    joints: np.ndarray = None            # node indices (J,)
    inverse_bind: np.ndarray = None      # (J, 4, 4)
    skeleton: Optional[int] = None


@dataclass
class SceneInfo:
    meshes: list = field(default_factory=list)
    materials: list = field(default_factory=list)
    images: list = field(default_factory=list)     # numpy RGBA u8 arrays
    image_srgb: list = field(default_factory=list)  # bool per image
    image_paths: list = field(default_factory=list)  # source path or None
    nodes: list = field(default_factory=list)
    roots: list = field(default_factory=list)
    cameras: list = field(default_factory=list)
    lights: list = field(default_factory=list)
    animations: list = field(default_factory=list)
    skins: list = field(default_factory=list)


def generate_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (smooth accumulation)."""
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)               # area-weighted
    n = np.zeros_like(pos)
    for k in range(3):
        np.add.at(n, idx[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-12)).astype(np.float32)


def generate_tangents(pos: np.ndarray, nrm: np.ndarray, uv: np.ndarray,
                      idx: np.ndarray) -> np.ndarray:
    """Per-vertex tangents from UV gradients (mikktspace-style accumulation
    without the full split/merge machinery; adequate for normal mapping)."""
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    t0, t1, t2 = uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    d1, d2 = t1 - t0, t2 - t0
    r = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(r) < 1e-12, 1.0, r)
    tdir = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) / r[:, None]
    tan = np.zeros_like(pos)
    for k in range(3):
        np.add.at(tan, idx[:, k], tdir)
    # Gram-Schmidt against the normal.
    tan -= nrm * (tan * nrm).sum(axis=1, keepdims=True)
    ln = np.linalg.norm(tan, axis=1, keepdims=True)
    bad = ln[:, 0] < 1e-8
    tan = tan / np.maximum(ln, 1e-12)
    # Fallback tangent for degenerate UVs: any vector orthogonal to n.
    if bad.any():
        alt = np.cross(nrm[bad], np.array([0.0, 0.0, 1.0], np.float32))
        alt_ln = np.linalg.norm(alt, axis=1, keepdims=True)
        alt2 = np.cross(nrm[bad], np.array([0.0, 1.0, 0.0], np.float32))
        alt = np.where(alt_ln > 1e-6, alt, alt2)
        tan[bad] = alt / np.maximum(np.linalg.norm(alt, axis=1,
                                                   keepdims=True), 1e-12)
    w = np.ones((len(pos), 1), np.float32)
    return np.concatenate([tan.astype(np.float32), w], axis=1)
