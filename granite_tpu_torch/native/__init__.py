"""Native host libraries of the port, built from source with g++ at first
use and bound with ctypes: the MLT2 meshlet codec here (meshlet2.cpp, a
copy of the MLT2 half of granite_tpu/native/granite_native.cpp), the MLT1
meshlet codec and radix_sort_u64 here too (meshlet1.cpp, its MLT1 and
radix-sort sections) and the texture codec in native/texture.py
(texture_codec.cpp, its texture half).

Each library is built with g++ -O2 -shared -fPIC -std=c++17 into the
repository's gitignored build/granite_tpu_torch/, under a name that
carries a hash of the source and flags (an edited source is rebuilt, a
stale binary never reused).  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().with_name("meshlet2.cpp")
MLT1_SOURCE = SOURCE.with_name("meshlet1.cpp")
GXX = "g++"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_mlt1_lib = None


def library_path(source: Path, build_dir: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return build_dir / f"libgranite_{source.stem}_{digest.hexdigest()[:16]}.so"


def compile_library(source: Path, build_dir: Path) -> Path:
    """Compile `source` into build_dir (no-op when the library for this
    exact source exists).  Raises RuntimeError with the compiler's output
    when the compiler fails or cannot be run."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [GXX, *GXX_FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"g++ failed: {' '.join(cmd)}: {err}") from err
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic against concurrent builders
    return out


def build() -> Path:
    """Compile meshlet2.cpp (see compile_library)."""
    return compile_library(SOURCE, BUILD_DIR)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.meshlet2_encode.argtypes = [f32p, f32p, f32p, ctypes.c_int, i32p,
                                        ctypes.c_int, u8p, ctypes.c_int,
                                        intp, intp]
        lib.meshlet2_encode.restype = ctypes.c_int
        lib.meshlet2_decode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                        f32p, f32p, f32p, i32p, intp, intp]
        lib.meshlet2_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def meshlet2_encode(positions: np.ndarray, normals, uvs,
                    indices: np.ndarray):
    """Full-attribute meshlet streams (MLT2).  Returns (blob bytes,
    num_meshlets)."""
    lib = get_lib()
    positions = np.ascontiguousarray(positions, np.float32)
    nv = len(positions)
    if normals is None:
        normals = np.zeros((nv, 3), np.float32)
    if uvs is None:
        uvs = np.zeros((nv, 2), np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    uvs = np.ascontiguousarray(uvs, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    if normals.shape != (nv, 3) or uvs.shape != (nv, 2) \
            or indices.ndim != 2 or indices.shape[1] != 3:
        raise ValueError("meshlet2_encode: positions (V,3), normals (V,3), "
                         "uvs (V,2), indices (T,3) expected")
    if len(indices) and (indices.min() < 0 or indices.max() >= nv):
        raise ValueError("meshlet2_encode: index out of range")
    nt = len(indices)
    size = ctypes.c_int()
    meshlets = ctypes.c_int()

    def encode(cap: int):
        out = np.empty(cap, np.uint8)
        rc = lib.meshlet2_encode(
            _ptr(positions, ctypes.c_float), _ptr(normals, ctypes.c_float),
            _ptr(uvs, ctypes.c_float), nv, _ptr(indices, ctypes.c_int32), nt,
            _ptr(out, ctypes.c_uint8), cap, ctypes.byref(size),
            ctypes.byref(meshlets))
        return rc, out

    rc, out = encode(128 + nv * 24 + nt * 16)
    if rc == -1:
        # Scattered indices duplicate vertices past the estimate; the
        # encoder reported the size it needs.
        rc, out = encode(size.value)
    if rc != 0:
        raise RuntimeError(f"meshlet2_encode failed rc={rc}")
    return bytes(out[:size.value]), meshlets.value


# Meshlet2Header: vertex and triangle counts (u32), position AABB and UV
# AABB (f32); then 14 bytes a vertex and 3 a triangle, padded to 4.
_HEADER_BYTES = 48
_VERTEX_BYTES = 14
# MLT1's MeshletHeader: the counts and the position AABB; 6 bytes a vertex.
_MLT1_HEADER_BYTES = 32
_MLT1_VERTEX_BYTES = 6


def blob_counts(data: np.ndarray, num_meshlets: int,
                header_bytes: int = _HEADER_BYTES,
                vertex_bytes: int = _VERTEX_BYTES) -> tuple[int, int]:
    """(vertices, triangles) a blob decodes to, read from its meshlet
    headers (MLT2's sizes by default); raises ValueError if the blob is
    shorter than they say."""
    off = vertices = triangles = 0
    for _ in range(num_meshlets):
        if off + header_bytes > len(data):
            raise ValueError("meshlet blob truncated")
        nv, nt = (int(c) for c in data[off:off + 8].view(np.uint32))
        off += header_bytes + nv * vertex_bytes
        off = (off + 3 * nt + 3) & ~3
        vertices += nv
        triangles += nt
    if off > len(data):
        raise ValueError("meshlet blob truncated")
    return vertices, triangles


def meshlet2_decode(blob: bytes, num_meshlets: int, max_vertices: int,
                    max_triangles: int):
    """-> (positions (V,3), normals (V,3), uvs (V,2), indices (T,3)).
    max_vertices / max_triangles: the decode capacity (an encoder
    duplicates shared vertices; 3 T and T bound them); a blob that
    decodes to more raises ValueError before any native call."""
    data = np.frombuffer(blob, np.uint8)
    nv_blob, nt_blob = blob_counts(data, num_meshlets)
    if nv_blob > max_vertices or nt_blob > max_triangles:
        raise ValueError(f"meshlet blob holds {nv_blob} vertices and "
                         f"{nt_blob} triangles, capacity {max_vertices} and "
                         f"{max_triangles}")
    lib = get_lib()
    pos = np.empty((max_vertices, 3), np.float32)
    nrm = np.empty((max_vertices, 3), np.float32)
    uv = np.empty((max_vertices, 2), np.float32)
    idx = np.empty((max_triangles, 3), np.int32)
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    rc = lib.meshlet2_decode(
        _ptr(data, ctypes.c_uint8), len(data), num_meshlets,
        _ptr(pos, ctypes.c_float), _ptr(nrm, ctypes.c_float),
        _ptr(uv, ctypes.c_float), _ptr(idx, ctypes.c_int32),
        ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError(f"meshlet2_decode failed rc={rc}")
    return (pos[:nv.value].copy(), nrm[:nv.value].copy(),
            uv[:nv.value].copy(), idx[:nt.value].copy())


def get_mlt1_lib() -> ctypes.CDLL:
    """meshlet1.cpp's library (built as compile_library says)."""
    global _mlt1_lib
    if _mlt1_lib is None:
        lib = ctypes.CDLL(str(compile_library(MLT1_SOURCE, BUILD_DIR)))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.meshlet_encode.argtypes = [f32p, ctypes.c_int, i32p, ctypes.c_int,
                                       u8p, ctypes.c_int, intp, intp]
        lib.meshlet_encode.restype = ctypes.c_int
        lib.meshlet_decode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                       f32p, i32p, intp, intp]
        lib.meshlet_decode.restype = ctypes.c_int
        lib.radix_sort_u64.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                       ctypes.POINTER(ctypes.c_uint32),
                                       ctypes.c_int]
        lib.radix_sort_u64.restype = None
        _mlt1_lib = lib
    return _mlt1_lib


def meshlet_encode(positions: np.ndarray, indices: np.ndarray):
    """Position-only meshlets (MLT1).  Returns (blob bytes, num_meshlets).
    Where the reference's capacity estimate is short (scattered indices
    duplicate vertices), the encoder's reported size is retried rather
    than raised."""
    lib = get_mlt1_lib()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    nv = len(positions)
    if positions.ndim != 2 or positions.shape[1] != 3 \
            or indices.ndim != 2 or indices.shape[1] != 3:
        raise ValueError("meshlet_encode: positions (V,3), indices (T,3) "
                         "expected")
    if len(indices) and (indices.min() < 0 or indices.max() >= nv):
        raise ValueError("meshlet_encode: index out of range")
    nt = len(indices)
    size = ctypes.c_int()
    meshlets = ctypes.c_int()

    def encode(cap: int):
        out = np.empty(cap, np.uint8)
        rc = lib.meshlet_encode(
            _ptr(positions, ctypes.c_float), nv,
            _ptr(indices, ctypes.c_int32), nt, _ptr(out, ctypes.c_uint8),
            cap, ctypes.byref(size), ctypes.byref(meshlets))
        return rc, out

    rc, out = encode(64 + nv * 8 + nt * 16)
    if rc == -1:
        rc, out = encode(size.value)
    if rc != 0:
        raise RuntimeError(f"meshlet_encode failed rc={rc}")
    return bytes(out[:size.value]), meshlets.value


def meshlet_decode(blob: bytes, num_meshlets: int, max_vertices: int,
                   max_triangles: int):
    """-> (positions (V,3) f32, indices (T,3) i32).  A blob that decodes
    to more than max_vertices / max_triangles, or is shorter than its
    headers say, raises ValueError before any native call."""
    data = np.frombuffer(blob, np.uint8)
    nv_blob, nt_blob = blob_counts(data, num_meshlets, _MLT1_HEADER_BYTES,
                                   _MLT1_VERTEX_BYTES)
    if nv_blob > max_vertices or nt_blob > max_triangles:
        raise ValueError(f"meshlet blob holds {nv_blob} vertices and "
                         f"{nt_blob} triangles, capacity {max_vertices} and "
                         f"{max_triangles}")
    lib = get_mlt1_lib()
    pos = np.empty((max_vertices, 3), np.float32)
    idx = np.empty((max_triangles, 3), np.int32)
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    rc = lib.meshlet_decode(
        _ptr(data, ctypes.c_uint8), len(data), num_meshlets,
        _ptr(pos, ctypes.c_float), _ptr(idx, ctypes.c_int32),
        ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError(f"meshlet_decode failed rc={rc}")
    return pos[:nv.value].copy(), idx[:nt.value].copy()


def radix_sort_u64(keys: np.ndarray) -> np.ndarray:
    """The stable ascending-order permutation (uint32) of 64-bit keys."""
    lib = get_mlt1_lib()
    keys = np.ascontiguousarray(keys, np.uint64)
    if keys.ndim != 1:
        raise ValueError("radix_sort_u64: 1-D keys expected")
    order = np.empty(len(keys), np.uint32)
    lib.radix_sort_u64(_ptr(keys, ctypes.c_uint64),
                       _ptr(order, ctypes.c_uint32), len(keys))
    return order
