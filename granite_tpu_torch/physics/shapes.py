"""Convex collision shapes: support maps, GJK/EPA, analytic raycasts
(copy of granite_tpu/physics/shapes.py, unchanged code: a tidied float64
expression would move the trajectories that tests/test_torch_physics.py
holds bit-equal).

Reference scope: physics/physics_system.{hpp,cpp} wraps Bullet's shape
zoo (btSphere/Box/Cone/Capsule/Cylinder/ConvexHull/BvhTriangleMesh,
physics_system.hpp:189-247).  Physics is host-side in the reference
(Bullet is CPU) and host-side here: rigid-body counts are tiny next to
pixel work, so the TPU-native split keeps simulation in vectorized
numpy on the host and ships only the resulting node transforms to the
device with the rest of the scene.  Instead of translating Bullet, the
narrowphase is one uniform GJK distance + EPA penetration pair over
support maps — every convex shape is ~5 lines of support function.

All shapes are centered at their local origin, axes match Bullet's
(capsule/cone/cylinder along +Y).  Quaternions are (w, x, y, z) per
muglm conventions.
"""

from __future__ import annotations

import numpy as np

from ..math.muglm import quat_rotate

_EPS = 1e-10


class Shape:
    """Convex support-map shape (local space)."""

    margin = 0.0

    def support(self, d: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def max_radius(self) -> float:
        """Bounding-sphere radius (AABB and broadphase helper)."""
        raise NotImplementedError

    def inertia_diag(self, mass: float) -> np.ndarray:
        """Principal inertia diagonal at the local origin."""
        raise NotImplementedError


class Sphere(Shape):
    def __init__(self, radius: float = 1.0):
        self.radius = float(radius)

    def support(self, d):
        n = np.linalg.norm(d)
        return d * (self.radius / n) if n > _EPS else \
            np.array([self.radius, 0, 0])

    def max_radius(self):
        return self.radius

    def inertia_diag(self, mass):
        i = 0.4 * mass * self.radius ** 2
        return np.array([i, i, i])


class Box(Shape):
    def __init__(self, half_extents=(1.0, 1.0, 1.0)):
        self.half = np.asarray(half_extents, np.float64)

    def support(self, d):
        return np.where(d >= 0.0, self.half, -self.half)

    def max_radius(self):
        return float(np.linalg.norm(self.half))

    def inertia_diag(self, mass):
        h2 = (2.0 * self.half) ** 2
        return mass / 12.0 * np.array([h2[1] + h2[2],
                                       h2[0] + h2[2],
                                       h2[0] + h2[1]])


class Capsule(Shape):
    """Segment along Y (half_height to the segment ends) + radius."""

    def __init__(self, radius: float, half_height: float):
        self.radius = float(radius)
        self.half_height = float(half_height)

    def support(self, d):
        n = np.linalg.norm(d)
        s = d * (self.radius / n) if n > _EPS else \
            np.array([self.radius, 0, 0])
        s = s.copy()
        s[1] += np.sign(d[1]) * self.half_height if abs(d[1]) > _EPS else 0
        return s

    def max_radius(self):
        return self.half_height + self.radius

    def inertia_diag(self, mass):
        # Solid-cylinder approximation (Bullet's btCapsuleShape does the
        # same class of approximation).
        r2 = self.radius ** 2
        h = 2.0 * (self.half_height + self.radius)
        ix = mass * (3.0 * r2 + h * h) / 12.0
        return np.array([ix, 0.5 * mass * r2, ix])


class Cylinder(Shape):
    def __init__(self, radius: float, half_height: float):
        self.radius = float(radius)
        self.half_height = float(half_height)

    def support(self, d):
        nxz = np.hypot(d[0], d[2])
        out = np.zeros(3)
        if nxz > _EPS:
            out[0] = d[0] * self.radius / nxz
            out[2] = d[2] * self.radius / nxz
        out[1] = np.sign(d[1]) * self.half_height
        return out

    def max_radius(self):
        return float(np.hypot(self.radius, self.half_height))

    def inertia_diag(self, mass):
        r2 = self.radius ** 2
        h2 = (2 * self.half_height) ** 2
        ix = mass * (3 * r2 + h2) / 12.0
        return np.array([ix, 0.5 * mass * r2, ix])


class Cone(Shape):
    """Apex at +half_height, base disc of `radius` at -half_height."""

    def __init__(self, radius: float, half_height: float):
        self.radius = float(radius)
        self.half_height = float(half_height)

    def support(self, d):
        # Either the apex or a point on the base rim wins.
        apex = np.array([0.0, self.half_height, 0.0])
        nxz = np.hypot(d[0], d[2])
        rim = np.array([0.0, -self.half_height, 0.0])
        if nxz > _EPS:
            rim[0] = d[0] * self.radius / nxz
            rim[2] = d[2] * self.radius / nxz
        return apex if np.dot(d, apex) >= np.dot(d, rim) else rim

    def max_radius(self):
        return float(max(self.half_height,
                         np.hypot(self.radius, self.half_height)))

    def inertia_diag(self, mass):
        r2 = self.radius ** 2
        h = 2.0 * self.half_height
        ix = mass * (3.0 / 20.0 * r2 + 3.0 / 80.0 * h * h)
        return np.array([ix, 3.0 / 10.0 * mass * r2, ix])


class ConvexHull(Shape):
    def __init__(self, points):
        self.points = np.asarray(points, np.float64).reshape(-1, 3)

    def support(self, d):
        return self.points[np.argmax(self.points @ d)]

    def max_radius(self):
        return float(np.sqrt((self.points ** 2).sum(axis=1).max()))

    def inertia_diag(self, mass):
        # Point-cloud covariance approximation.
        c = self.points - self.points.mean(axis=0)
        sq = (c ** 2).mean(axis=0)
        return mass * np.array([sq[1] + sq[2], sq[0] + sq[2],
                                sq[0] + sq[1]])


class Triangle(Shape):
    """One mesh triangle as a (degenerate) convex — the static
    triangle-mesh narrowphase runs plain GJK against these."""

    def __init__(self, verts):
        self.points = np.asarray(verts, np.float64).reshape(3, 3)

    def support(self, d):
        return self.points[np.argmax(self.points @ d)]

    def max_radius(self):
        return float(np.sqrt((self.points ** 2).sum(axis=1).max()))

    def inertia_diag(self, mass):
        return np.full(3, mass)          # static-only; never integrated


# ---------------------------------------------------------------------------
# World-space support of a posed shape.
# ---------------------------------------------------------------------------

def _quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


class Posed:
    """(shape, world position, world rotation quat wxyz)."""

    __slots__ = ("shape", "pos", "rot", "_conj")

    def __init__(self, shape: Shape, pos, rot):
        self.shape = shape
        self.pos = np.asarray(pos, np.float64)
        self.rot = np.asarray(rot, np.float64)
        self._conj = _quat_conj(self.rot)

    def support(self, d: np.ndarray) -> np.ndarray:
        local = quat_rotate(self._conj, d)
        return quat_rotate(self.rot, self.shape.support(local)) + self.pos

    def aabb(self) -> np.ndarray:
        """(2, 3) [min, max] via 6 axis supports (exact for support maps)."""
        lo = np.empty(3)
        hi = np.empty(3)
        for a in range(3):
            d = np.zeros(3)
            d[a] = 1.0
            hi[a] = self.support(d)[a]
            d[a] = -1.0
            lo[a] = self.support(d)[a]
        return np.stack([lo, hi])


# ---------------------------------------------------------------------------
# GJK distance + EPA penetration.
# ---------------------------------------------------------------------------

def _minkowski_support(a: Posed, b: Posed, d):
    pa = a.support(d)
    pb = b.support(-d)
    return pa - pb, pa, pb


def _closest_on_simplex(simplex):
    """Closest point to origin on a 1-3 point simplex.
    Returns (point, barycentric weights, reduced index list)."""
    pts = np.asarray([s[0] for s in simplex])
    n = len(pts)
    if n == 1:
        return pts[0], np.array([1.0]), [0]
    if n == 2:
        ab = pts[1] - pts[0]
        t = -np.dot(pts[0], ab) / max(np.dot(ab, ab), _EPS)
        if t <= 0.0:
            return pts[0], np.array([1.0]), [0]
        if t >= 1.0:
            return pts[1], np.array([1.0]), [1]
        return pts[0] + t * ab, np.array([1.0 - t, t]), [0, 1]
    # Triangle: project origin, clamp to edges via voronoi regions.
    a, b, c = pts
    ab = b - a
    ac = c - a
    ap = -a
    d1 = np.dot(ab, ap)
    d2 = np.dot(ac, ap)
    if d1 <= 0 and d2 <= 0:
        return a, np.array([1.0]), [0]
    bp = -b
    d3 = np.dot(ab, bp)
    d4 = np.dot(ac, bp)
    if d3 >= 0 and d4 <= d3:
        return b, np.array([1.0]), [1]
    vc = d1 * d4 - d3 * d2
    if vc <= 0 and d1 >= 0 and d3 <= 0:
        t = d1 / max(d1 - d3, _EPS)
        return a + t * ab, np.array([1.0 - t, t]), [0, 1]
    cp = -c
    d5 = np.dot(ab, cp)
    d6 = np.dot(ac, cp)
    if d6 >= 0 and d5 <= d6:
        return c, np.array([1.0]), [2]
    vb = d5 * d2 - d1 * d6
    if vb <= 0 and d2 >= 0 and d6 <= 0:
        t = d2 / max(d2 - d6, _EPS)
        return a + t * ac, np.array([1.0 - t, t]), [0, 2]
    va = d3 * d6 - d5 * d4
    if va <= 0 and (d4 - d3) >= 0 and (d5 - d6) >= 0:
        t = (d4 - d3) / max((d4 - d3) + (d5 - d6), _EPS)
        return b + t * (c - b), np.array([1.0 - t, t]), [1, 2]
    denom = max(va + vb + vc, _EPS)
    v = vb / denom
    w = vc / denom
    return a + ab * v + ac * w, np.array([1.0 - v - w, v, w]), [0, 1, 2]


def gjk_distance(a: Posed, b: Posed, max_iter: int = 64):
    """Distance query.  Returns (dist, point_on_a, point_on_b,
    normal_b_to_a) for separated pairs, or (0, None, None, None) when
    the shapes overlap (run EPA for depth)."""
    d = a.pos - b.pos
    if np.dot(d, d) < _EPS:
        d = np.array([1.0, 0.0, 0.0])
    simplex = [_minkowski_support(a, b, d)]
    for _ in range(max_iter):
        p, w, keep = _closest_on_simplex(simplex)
        simplex = [simplex[i] for i in keep]
        dist = np.linalg.norm(p)
        if dist < 1e-9:
            return 0.0, None, None, None
        d = -p
        new = _minkowski_support(a, b, d)
        # No progress toward the origin => p is the closest point.
        if np.dot(new[0], d) - np.dot(p, d) < 1e-10 * max(dist, 1.0):
            pa = sum(wi * s[1] for wi, s in zip(w, simplex))
            pb = sum(wi * s[2] for wi, s in zip(w, simplex))
            return dist, pa, pb, p / dist
        simplex.append(new)
        if len(simplex) == 4:
            # Tetrahedron: check if origin is enclosed.
            inside, face = _origin_in_tetra(simplex)
            if inside:
                return 0.0, None, None, None
            simplex = [simplex[i] for i in face]
    p, w, keep = _closest_on_simplex(simplex[:3])
    simplex = [simplex[i] for i in keep]
    dist = max(np.linalg.norm(p), 1e-12)
    pa = sum(wi * s[1] for wi, s in zip(w, simplex))
    pb = sum(wi * s[2] for wi, s in zip(w, simplex))
    return dist, pa, pb, p / dist


def _origin_in_tetra(simplex):
    """(is_inside, indices of the face closest to the origin if not)."""
    pts = np.asarray([s[0] for s in simplex])
    faces = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    best = None
    best_d = np.inf
    inside = True
    for f in faces:
        a, bb, c = pts[f[0]], pts[f[1]], pts[f[2]]
        opp = pts[[i for i in range(4) if i not in f][0]]
        n = np.cross(bb - a, c - a)
        nn = np.linalg.norm(n)
        if nn < _EPS:
            continue
        n = n / nn
        if np.dot(n, opp - a) > 0:
            n = -n
        side = np.dot(n, -a)           # >0: origin outside this face
        if side > 1e-12:
            inside = False
        dist = abs(np.dot(n, a))
        if side > -1e-12 and dist < best_d:
            best_d = dist
            best = list(f)
    return inside, (best if best is not None else [0, 1, 2])


def epa_penetration(a: Posed, b: Posed, max_iter: int = 64):
    """Penetration depth + normal for overlapping shapes.
    Returns (depth, normal pointing from b to a, contact point) or None
    if a valid polytope cannot be built (degenerate contact)."""
    # Seed polytope: tetrahedron from 4 spread directions.
    dirs = [np.array([1.0, 0, 0]), np.array([-1.0, 1.0, 0]),
            np.array([-1.0, -1.0, 1.0]), np.array([-1.0, -1.0, -1.0])]
    verts = []
    for d in dirs:
        verts.append(_minkowski_support(a, b, d))
    pts = np.asarray([v[0] for v in verts])
    if abs(np.linalg.det(pts[1:] - pts[0])) < 1e-12:
        for d in (np.array([0, 1.0, 0]), np.array([0, 0, 1.0]),
                  np.array([0.7, 0.7, 0]), np.array([0, -1.0, 0.3])):
            verts.append(_minkowski_support(a, b, d))
        # Pick any non-degenerate 4-subset.
        from itertools import combinations
        ok = None
        for comb in combinations(range(len(verts)), 4):
            q = np.asarray([verts[i][0] for i in comb])
            if abs(np.linalg.det(q[1:] - q[0])) > 1e-12:
                ok = [verts[i] for i in comb]
                break
        if ok is None:
            return None
        verts = ok
    faces = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]

    def face_info(f):
        p0, p1, p2 = (verts[f[0]][0], verts[f[1]][0], verts[f[2]][0])
        n = np.cross(p1 - p0, p2 - p0)
        nn = np.linalg.norm(n)
        if nn < _EPS:
            return None
        n = n / nn
        d = np.dot(n, p0)
        if d < 0:
            n, d = -n, -d
        return n, d

    for _ in range(max_iter):
        infos = [(f, face_info(f)) for f in faces]
        infos = [(f, i) for f, i in infos if i is not None]
        if not infos:
            return None
        f, (n, d) = min(infos, key=lambda fi: fi[1][1])
        new = _minkowski_support(a, b, n)
        if np.dot(new[0], n) - d < 1e-7:
            # Converged: contact point from barycentric proj on face.
            pa = _epa_witness(verts, f, n, d, idx=1)
            return max(d, 0.0), n, pa
        verts.append(new)
        ni = len(verts) - 1
        # Remove faces seen by the new vertex; stitch the hole.
        visible = []
        for ff in faces:
            fi = face_info(ff)
            if fi is None:
                visible.append(ff)
                continue
            if np.dot(fi[0], verts[ni][0]) > fi[1] + 1e-12:
                visible.append(ff)
        if not visible:
            pa = _epa_witness(verts, f, n, d, idx=1)
            return max(d, 0.0), n, pa
        edge_count: dict = {}
        for ff in visible:
            for e in ((ff[0], ff[1]), (ff[1], ff[2]), (ff[2], ff[0])):
                key = tuple(sorted(e))
                edge_count[key] = edge_count.get(key, 0) + 1
        faces = [ff for ff in faces if ff not in visible]
        for (e0, e1), cnt in edge_count.items():
            if cnt == 1:
                faces.append((e0, e1, ni))
        if not faces:
            return None
    f, info = min(((f, face_info(f)) for f in faces
                   if face_info(f) is not None),
                  key=lambda fi: fi[1][1], default=(None, None))
    if info is None:
        return None
    n, d = info
    pa = _epa_witness(verts, f, n, d, idx=1)
    return max(d, 0.0), n, pa


def _epa_witness(verts, face, n, d, idx):
    """Witness point on shape A: barycentric coords of the face point
    closest to the origin applied to the A-side support points."""
    p0, p1, p2 = (verts[face[0]][0], verts[face[1]][0], verts[face[2]][0])
    proj = n * d
    # Barycentric of proj in (p0, p1, p2).
    v0 = p1 - p0
    v1 = p2 - p0
    v2 = proj - p0
    d00 = np.dot(v0, v0)
    d01 = np.dot(v0, v1)
    d11 = np.dot(v1, v1)
    d20 = np.dot(v2, v0)
    d21 = np.dot(v2, v1)
    den = max(d00 * d11 - d01 * d01, _EPS)
    v = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    u = 1.0 - v - w
    a0, a1, a2 = (verts[face[0]][idx], verts[face[1]][idx],
                  verts[face[2]][idx])
    return u * a0 + v * a1 + w * a2


# ---------------------------------------------------------------------------
# Raycasts (analytic where cheap, GJK sphere-tracing otherwise).
# ---------------------------------------------------------------------------

def ray_sphere(o, d, radius):
    b = np.dot(o, d)
    c = np.dot(o, o) - radius * radius
    disc = b * b - c
    if disc < 0:
        return None
    t = -b - np.sqrt(disc)
    return t if t >= 0 else None


def ray_box(o, d, half):
    inv = 1.0 / np.where(np.abs(d) > _EPS, d, np.copysign(_EPS, d))
    t0 = (-half - o) * inv
    t1 = (half - o) * inv
    tmin = np.minimum(t0, t1).max()
    tmax = np.maximum(t0, t1).min()
    if tmax < max(tmin, 0.0):
        return None
    return tmin if tmin >= 0 else None


def ray_convex_trace(o, d, posed: Posed, length: float, eps=1e-5,
                     max_steps=64):
    """Sphere-trace the exact convex distance field (GJK point-vs-shape)
    — uniform fallback for capsule/cylinder/cone/hull."""
    t = 0.0
    pt_shape = Sphere(0.0)
    for _ in range(max_steps):
        p = Posed(pt_shape, o + t * d, np.array([1.0, 0, 0, 0]))
        dist, _, _, _ = gjk_distance(p, posed)
        if dist < eps:
            return t
        t += dist
        if t > length:
            return None
    return None


def ray_triangles(o, d, tri_pts, length):
    """Vectorized Moller-Trumbore over (T, 3, 3) triangles.
    Returns (t, tri_index, normal) of the nearest hit or None."""
    v0 = tri_pts[:, 0]
    e1 = tri_pts[:, 1] - v0
    e2 = tri_pts[:, 2] - v0
    h = np.cross(d[None, :], e2)
    det = (e1 * h).sum(axis=1)
    ok = np.abs(det) > _EPS
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    s = o[None, :] - v0
    u = (s * h).sum(axis=1) * inv
    q = np.cross(s, e1)
    v = (d[None, :] * q).sum(axis=1) * inv
    t = (e2 * q).sum(axis=1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0) & (t <= length)
    if not hit.any():
        return None
    idx = np.where(hit, t, np.inf).argmin()
    n = np.cross(e1[idx], e2[idx])
    n /= max(np.linalg.norm(n), _EPS)
    if np.dot(n, d) > 0:
        n = -n
    return float(t[idx]), int(idx), n
