"""The port's MLT2 meshlet codec (granite_tpu_torch/native, its own copy
of the JAX package's native source) and the meshlet half of MeshData,
held against granite_tpu.native and granite_tpu.scene.scene_formats, and
the deferred_meshlet golden config rendered end to end on the CPU.

Blobs byte-equal, decoded arrays equal, packed scenes equal: the codec is
the same C++ and the decode the same numpy."""

import json
import os
import tempfile
import types

import numpy as np
import pytest
import torch

from golden_utils import CONFIGS, FRAMES, GOLDEN_DIR, SIZE, TIME_STEP, psnr
from granite_tpu import native as JN
from granite_tpu.app.scene_viewer import (
    build_default_test_scene as jax_test_scene,
)
from granite_tpu.renderer.ground import fbm_heightmap, ground_mesh
from granite_tpu.renderer.scene_renderer import pack_scene as jax_pack
from granite_tpu.utils.image_io import load_image
from granite_tpu_torch import native as TN
from granite_tpu_torch.app import bench_scene as TB
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.renderer.scene_renderer import pack_scene

GATE_DB = 48.0
SEED = 21


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process: the Tier-1 run puts several
    xdist workers on the machine's cores, and torch's default pool (a
    thread a core in every worker) then oversubscribes them, and a CPU
    render's thousands of small ops slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes():
    """The test scene's meshes, a terrain grid and a random soup with
    zero normals and UVs left out (the encoder's empty-AABB cases)."""
    rng = np.random.default_rng(SEED)
    out = [(f"scene{i}", md.positions, md.normals, md.uvs, md.indices)
           for i, md in enumerate(jax_test_scene().meshes)]
    g = ground_mesh(fbm_heightmap(32, seed=SEED), 20.0, 24)
    out.append(("ground", g.positions, g.normals, g.uvs, g.indices))
    out.append(("soup", *_soup(rng, 60, 500)))
    return out


def _soup(rng, nv, nt):
    pos = rng.normal(size=(nv, 3)).astype(np.float32)
    nrm = np.zeros((nv, 3), np.float32)
    nrm[::2] = rng.normal(size=(nv - nv // 2, 3))
    idx = rng.integers(0, nv, (nt, 3)).astype(np.int32)
    return pos, nrm, None, idx


MESHES = {m[0]: m[1:] for m in _meshes()}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_meshlet2_codec_matches_jax(name):
    pos, nrm, uv, idx = MESHES[name]
    blob, n = TN.meshlet2_encode(pos, nrm, uv, idx)
    want_blob, want_n = JN.meshlet2_encode(pos, nrm, uv, idx)
    assert n == want_n > 0
    assert blob == want_blob
    cap_v, cap_t = 3 * len(idx), len(idx)
    got = TN.meshlet2_decode(blob, n, cap_v, cap_t)
    want = JN.meshlet2_decode(want_blob, n, cap_v, cap_t)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert TN.blob_counts(np.frombuffer(blob, np.uint8), n) \
        == (len(got[0]), len(got[3]))


def test_meshlet2_encode_grows_past_the_estimate():
    """Scattered indices duplicate vertices past the first buffer's
    estimate (where the JAX binding raises): the port encodes again at
    the size the encoder reports, and the JAX decoder reads the blob."""
    pos, nrm, uv, idx = _soup(np.random.default_rng(SEED), 300, 500)
    with pytest.raises(RuntimeError):
        JN.meshlet2_encode(pos, nrm, uv, idx)
    blob, n = TN.meshlet2_encode(pos, nrm, uv, idx)
    got = TN.meshlet2_decode(blob, n, 3 * len(idx), len(idx))
    want = JN.meshlet2_decode(blob, n, 3 * len(idx), len(idx))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert len(got[0]) > 128 + 300 * 24 // 14
    assert np.array_equal(got[3].shape, idx.shape)


def test_meshlet2_decode_checks_capacity():
    pos, nrm, uv, idx = MESHES["scene0"]
    blob, n = TN.meshlet2_encode(pos, nrm, uv, idx)
    nv, nt = TN.blob_counts(np.frombuffer(blob, np.uint8), n)
    with pytest.raises(ValueError):
        TN.meshlet2_decode(blob, n, nv - 1, nt)
    with pytest.raises(ValueError):
        TN.meshlet2_decode(blob[:len(blob) // 2], n, 3 * nt, nt)
    with pytest.raises(ValueError):
        TN.meshlet2_encode(pos, nrm, uv, idx + len(pos))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "meshlet2.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "SOURCE", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TN.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_meshdata_meshlets_and_pack_scene_match_jax():
    """MeshData.to_meshlets / finalize and pack_scene over meshlet meshes
    give the JAX package's records and packed arrays."""
    ref, got = jax_test_scene(), TB.build_default_test_scene()
    ref.meshes = [md.to_meshlets() for md in ref.meshes]
    got.meshes = [md.to_meshlets() for md in got.meshes]
    for a, b in zip(ref.meshes, got.meshes):
        assert (a.encoding, a.meshlet_count, a.meshlet_vertices,
                a.meshlet_triangles) == (b.encoding, b.meshlet_count,
                                         b.meshlet_vertices,
                                         b.meshlet_triangles) \
            == ("meshlet", a.meshlet_count, a.meshlet_vertices,
                a.meshlet_triangles)
        assert a.meshlet_blob == b.meshlet_blob and b.positions is None
    want = jax_pack(ref)
    have = pack_scene(got)
    for name, arr in want.device_arrays().items():
        w = np.asarray(arr)
        h = getattr(have, name).numpy()
        assert h.dtype == w.dtype and np.array_equal(h, w), name
    for a, b in zip(ref.meshes, got.meshes):
        for f in ("positions", "normals", "uvs", "tangents", "indices",
                  "aabb_min", "aabb_max"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_meshlet_golden_png():
    """deferred_meshlet: every mesh of the test scene re-encoded through
    MLT2 and decoded at pack time, against the golden."""
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(CONFIGS["deferred_meshlet"], f)
    try:
        app = SceneViewerApplication(types.SimpleNamespace(
            config=f.name, bench_scene=False), device="cpu")
    finally:
        os.unlink(f.name)
    assert app.meshlet_meshes == len(app.info.meshes) > 0
    assert all(md.encoding == "meshlet" for md in app.info.meshes)
    app.swapchain_updated(*SIZE)
    out = None
    for i in range(FRAMES):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
    golden = load_image(os.path.join(GOLDEN_DIR, "deferred_meshlet.png"))
    got = out.numpy()
    assert got.shape == golden.shape
    assert psnr(got, golden) >= GATE_DB
