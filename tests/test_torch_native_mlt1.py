"""The port's MLT1 meshlet codec and radix_sort_u64
(granite_tpu_torch/native/meshlet1.cpp, built with g++ at first use)
held against granite_tpu.native on seeded meshes and keys: blobs
byte-equal and decodes equal (meshes of one triangle, of more than 64
vertices and more than 126 triangles, a grid and scattered indices),
orders equal (duplicates, n = 0 and 1, keys past 2^63).  Decode
reproduces each position within one 16-bit quantization step of its
meshlet's AABB."""

import numpy as np
import pytest

from granite_tpu import native as JN
from granite_tpu_torch import native as TN

SEED = 5


def _grid(n: int):
    """An n x n vertex grid with two triangles a quad."""
    y, x = np.mgrid[0:n, 0:n]
    pos = np.stack([x, np.sin(x * 0.3) * y * 0.1, y], -1) \
        .reshape(-1, 3).astype(np.float32)
    q = (y[:-1, :-1] * n + x[:-1, :-1]).reshape(-1)
    idx = np.concatenate([np.stack([q, q + 1, q + n], -1),
                          np.stack([q + 1, q + n + 1, q + n], -1)])
    return pos, idx.astype(np.int32)


def _meshes():
    rng = np.random.default_rng(SEED)
    one = (rng.normal(size=(3, 3)).astype(np.float32),
           np.array([[0, 1, 2]], np.int32))
    grid = _grid(24)                           # 576 vertices, 1058 tris
    pos = rng.normal(size=(200, 3)).astype(np.float32) * 10
    local = rng.integers(0, 40, (150, 3)).astype(np.int32)
    flat = (np.zeros((70, 3), np.float32),     # a zero-extent AABB
            rng.integers(0, 70, (130, 3)).astype(np.int32))
    return {"one triangle": one, "grid 24x24": grid,
            "local indices": (pos, local), "flat": flat}


@pytest.mark.parametrize("name", list(_meshes()))
def test_meshlet_blobs_match_jax(name):
    pos, idx = _meshes()[name]
    got, n = TN.meshlet_encode(pos, idx)
    want, n_want = JN.meshlet_encode(pos, idx)
    assert n == n_want and got == want
    cap_v, cap_t = 3 * len(idx), len(idx)
    p, i = TN.meshlet_decode(got, n, cap_v, cap_t)
    pj, ij = JN.meshlet_decode(want, n_want, cap_v, cap_t)
    assert np.array_equal(p, pj) and np.array_equal(i, ij)
    # every decoded triangle is its source triangle, each position
    # within a quantization step of its meshlet's extent
    assert np.array_equal(i.shape, idx.shape)
    src, dec = pos[idx], p[i]
    step = (pos.max(0) - pos.min(0)) / 65535.0
    assert (np.abs(src - dec) <= step + 1e-6).all()


def test_meshlet_limits_split_meshlets():
    """The grid fills meshlets of <= 64 vertices and <= 126 triangles."""
    pos, idx = _grid(24)
    blob, n = TN.meshlet_encode(pos, idx)
    data = np.frombuffer(blob, np.uint8)
    off, counts = 0, []
    for _ in range(n):
        nv, nt = (int(c) for c in data[off:off + 8].view(np.uint32))
        counts.append((nv, nt))
        off = (off + 32 + 6 * nv + 3 * nt + 3) & ~3
    assert off == len(blob) and n > 1
    assert max(c[0] for c in counts) <= 64
    assert max(c[1] for c in counts) <= 126
    assert sum(c[1] for c in counts) == len(idx)


def test_scattered_indices_past_the_capacity_estimate():
    """Scattered indices duplicate vertices past the reference's
    capacity estimate, where granite_tpu.native raises; the port retries
    with the size the encoder reports and decodes the mesh."""
    rng = np.random.default_rng(SEED)
    pos = rng.normal(size=(1000, 3)).astype(np.float32)
    idx = rng.integers(0, 1000, (3000, 3)).astype(np.int32)
    with pytest.raises(RuntimeError):
        JN.meshlet_encode(pos, idx)
    blob, n = TN.meshlet_encode(pos, idx)
    p, i = TN.meshlet_decode(blob, n, 3 * len(idx), len(idx))
    step = (pos.max(0) - pos.min(0)) / 65535.0
    assert (np.abs(pos[idx] - p[i]) <= step + 1e-6).all()


def test_meshlet_checks():
    pos, idx = _grid(12)
    blob, n = TN.meshlet_encode(pos, idx)
    nv, nt = TN.blob_counts(np.frombuffer(blob, np.uint8), n, 32, 6)
    with pytest.raises(ValueError):
        TN.meshlet_decode(blob, n, nv - 1, nt)
    with pytest.raises(ValueError):
        TN.meshlet_decode(blob[:len(blob) // 2], n, 3 * nt, nt)
    with pytest.raises(ValueError):
        TN.meshlet_encode(pos, idx + len(pos))


@pytest.mark.parametrize("case", ["random", "duplicates", "empty", "one",
                                  "high bits"])
def test_radix_sort_matches_jax(case):
    rng = np.random.default_rng(SEED)
    keys = {"random": rng.integers(0, 2**63, 1000, dtype=np.uint64),
            "duplicates": rng.integers(0, 7, 513).astype(np.uint64),
            "empty": np.zeros(0, np.uint64),
            "one": np.array([42], np.uint64),
            "high bits": (rng.integers(0, 4, 300).astype(np.uint64)
                          << np.uint64(62))
            | rng.integers(0, 3, 300).astype(np.uint64)}[case]
    got = TN.radix_sort_u64(keys)
    assert got.dtype == np.uint32
    assert np.array_equal(got, JN.radix_sort_u64(keys))
    assert np.array_equal(got, np.argsort(keys, kind="stable"))
