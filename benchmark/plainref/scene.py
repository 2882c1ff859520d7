"""The scene as flat arrays in float64: every mesh instance's vertices in
world space, its triangles, its material, and the camera, sun and light
matrices, all worked out from the scene description (a SceneInfo) alone.

Conventions (Granite's, which the renderer under test keeps): column
vectors, quaternions (w, x, y, z), a view matrix that looks down -Z,
reverse-Z projections (near 1, far 0; infinite far for the main camera)
with Y flipped, clip space -w <= x, y <= w and 0 <= z <= w.
"""

from __future__ import annotations

import numpy as np
import torch

LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
ALPHA_MODE_BLEND = 2

# The viewer's sun when the scene has no directional light.
SUN_DIR = (0.35, 0.9, 0.25)
SUN_COLOR = (3.0, 2.8, 2.5)
# A positional light's reach when the scene gives it none.
DEFAULT_LIGHT_RANGE = 100.0


def quat_to_mat3(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def trs(t, q, s) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quat_to_mat3(q) * np.asarray(s, np.float64)[None, :]
    m[:3, 3] = t
    return m


def camera_view(position, rotation) -> np.ndarray:
    """World -> view: the rotation's matrix after a translation by
    -position."""
    m = np.eye(4)
    m[:3, :3] = quat_to_mat3(rotation)
    m[:3, 3] = -m[:3, :3] @ np.asarray(position, np.float64)
    return m


def perspective(fovy: float, aspect: float, znear: float,
                zfar: float | None = None) -> np.ndarray:
    """Reverse-Z, Y-flipped perspective; zfar None: infinite far plane
    (z_clip = znear, so z_ndc = znear / w)."""
    t = np.tan(0.5 * fovy)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = -1.0 / t
    if zfar is None:
        m[2, 3] = znear
    else:
        m[2, 2] = znear / (zfar - znear)
        m[2, 3] = zfar * znear / (zfar - znear)
    m[3, 2] = -1.0
    return m


def ortho(half: float, znear: float, zfar: float) -> np.ndarray:
    """Reverse-Z, Y-flipped orthographic box [-half, half]^2 x [znear,
    zfar] in front of the eye."""
    m = np.eye(4)
    m[0, 0] = 1.0 / half
    m[1, 1] = -1.0 / half
    m[2, 2] = 1.0 / (zfar - znear)
    m[2, 3] = 1.0 + znear / (zfar - znear)
    return m


def look_at(eye, centre, up) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    f = np.asarray(centre, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = r, u, -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def sun_matrix(sun_dir, lo, hi) -> np.ndarray:
    """The sun's orthographic view-projection fitted around the scene's
    bounds [lo, hi]: a box of the bounds' radius, the eye 1.5 radii up
    the sun direction from the centre, depth from 0.5 to 2.5 radii."""
    d = np.asarray(sun_dir, np.float64)
    d /= np.linalg.norm(d)
    centre = 0.5 * (lo + hi)
    radius = 0.5 * float(np.linalg.norm(hi - lo))
    up = (0.0, 0.0, 1.0) if abs(d[1]) > 0.99 else (0.0, 1.0, 0.0)
    view = look_at(centre + d * radius * 1.5, centre, up)
    return ortho(radius, 0.5 * radius, 2.5 * radius) @ view


# Cube faces of a point light's shadow: +X, -X, +Y, -Y, +Z, -Z, each with
# its up vector.
CUBE_FACES = (((1, 0, 0), (0, 1, 0)), ((-1, 0, 0), (0, 1, 0)),
              ((0, 1, 0), (0, 0, 1)), ((0, -1, 0), (0, 0, -1)),
              ((0, 0, 1), (0, 1, 0)), ((0, 0, -1), (0, 1, 0)))


def light_near(radius: float) -> float:
    return max(0.005 * radius, 1e-3)


def cube_face_matrices(pos, radius: float) -> np.ndarray:
    """(6, 4, 4): 90-degree square perspectives from the light, depth
    from light_near(radius) to radius."""
    proj = perspective(np.pi / 2, 1.0, light_near(radius), radius)
    pos = np.asarray(pos, np.float64)
    return np.stack([proj @ look_at(pos, pos + np.asarray(d, np.float64), u)
                     for d, u in CUBE_FACES])


def world_aabbs(world, lo, hi):
    """World bounds of local boxes [lo, hi] under (N, 4, 4) transforms."""
    c = 0.5 * (lo + hi)
    e = 0.5 * (hi - lo)
    rot = world[:, :3, :3]
    wc = np.einsum("nij,nj->ni", rot, c) + world[:, :3, 3]
    we = np.einsum("nij,nj->ni", np.abs(rot), e)
    return wc - we, wc + we


def scene_bounds(info):
    """World bounds (lo, hi) of every mesh instance's box."""
    arrays = SceneArrays(info, "cpu", geometry=False)
    return arrays.lo, arrays.hi


class SceneArrays:
    """Every mesh instance of a SceneInfo, flattened.  Instances are in
    node order; nothing here is skinned or morphed (the reference refuses
    such scenes)."""

    def __init__(self, info, device, geometry: bool = True):
        """geometry=False: the transforms, boxes and lights only."""
        self.device = torch.device(device)
        n = len(info.nodes)
        parent = {c: i for i, nd in enumerate(info.nodes) for c in nd.children}
        world = [None] * n

        def world_of(i):
            if world[i] is None:
                nd = info.nodes[i]
                local = trs(nd.translation, nd.rotation, nd.scale)
                world[i] = local if i not in parent else \
                    world_of(parent[i]) @ local
            return world[i]

        self.world = np.stack([world_of(i) for i in range(n)])
        pos, nrm, uv, idx, mat, obj = [], [], [], [], [], []
        obj_lo, obj_hi = [], []
        v0 = 0
        for node, nd in enumerate(info.nodes):
            for mi in nd.meshes:
                md = info.meshes[mi]
                if md.positions is None or md.joints is not None or \
                        md.morph_position_deltas is not None:
                    raise ValueError("the reference draws static meshes only")
                m = info.materials[max(md.material, 0)] \
                    if info.materials else None
                if m is not None and m.alpha_mode == ALPHA_MODE_BLEND:
                    raise ValueError("the reference has no transparent queue")
                w = self.world[node]
                lo, hi = world_aabbs(w[None], np.asarray(md.aabb_min)[None],
                                     np.asarray(md.aabb_max)[None])
                obj_lo.append(lo[0])
                obj_hi.append(hi[0])
                if not geometry:
                    continue
                p = np.asarray(md.positions, np.float64)
                pos.append(p @ w[:3, :3].T + w[:3, 3])
                nmat = np.linalg.inv(w[:3, :3]).T
                nrm.append(np.asarray(md.normals, np.float64) @ nmat.T)
                uv.append(np.asarray(md.uvs, np.float64))
                idx.append(np.asarray(md.indices, np.int64) + v0)
                mat.append(np.full(len(md.indices), max(md.material, 0)))
                obj.append(np.full(len(md.indices), len(obj_lo) - 1))
                v0 += len(p)

        self.obj_lo = np.stack(obj_lo)
        self.obj_hi = np.stack(obj_hi)
        self.lo = self.obj_lo.min(axis=0)
        self.hi = self.obj_hi.max(axis=0)
        self._lights(info)
        if not geometry:
            return

        def dev(parts, dtype):
            return torch.as_tensor(np.concatenate(parts), dtype=dtype,
                                   device=self.device)

        self.positions = dev(pos, torch.float64)      # (V, 3) world
        self.normals = dev(nrm, torch.float64)        # (V, 3) world
        self.uvs = dev(uv, torch.float64)             # (V, 2)
        self.indices = dev(idx, torch.int64)          # (T, 3)
        self.tri_material = dev(mat, torch.int64)     # (T,)
        self.tri_object = dev(obj, torch.int64)       # (T,)

    def _lights(self, info):
        self.sun_dir = np.asarray(SUN_DIR, np.float64)
        self.sun_dir /= np.linalg.norm(self.sun_dir)
        self.sun_color = np.asarray(SUN_COLOR, np.float64)
        self.lights = []
        for i, nd in enumerate(info.nodes):
            if nd.light is None:
                continue
            light = info.lights[nd.light]
            color = np.asarray(light.color, np.float64) * light.intensity
            if light.type == LIGHT_DIRECTIONAL:
                self.sun_color = color
            elif light.type == LIGHT_POINT:
                self.lights.append({
                    "pos": self.world[i][:3, 3].copy(), "color": color,
                    "radius": float(light.range) if light.range > 0
                    else DEFAULT_LIGHT_RANGE})
            else:
                raise ValueError("the reference has no spot lights")

    def clip(self, view_proj: np.ndarray) -> torch.Tensor:
        """(V, 4) float64 clip-space positions under a view-projection."""
        m = torch.as_tensor(view_proj, dtype=torch.float64,
                            device=self.device)
        return self.positions @ m[:, :3].T + m[:, 3]
