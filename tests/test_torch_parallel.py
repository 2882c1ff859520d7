"""granite_tpu_torch.parallel against granite_tpu.parallel on the CPU.

One `spawn_ranks(4, backend="gloo", device="cpu")` launch, shared by the
module's fixture, runs the sharded raster, the toy two-pass graph and
the deferred frame in four processes (the rank functions live in the
port: a rank never imports jax); the entry point runs beside it in a
process of its own, and the JAX viewer's same deferred frame through
JAX's shard_frame_step on 4 of conftest's CPU devices runs in this
process meanwhile.  The same numpy triangle setup (the JAX sharding
test's 24-sphere field, seed 2, 256x256, built by the JAX package) goes
to both packages."""

import json
import os
import subprocess
import sys
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import psnr
import granite_tpu.ops.raster as JR
from granite_tpu.graph import AttachmentInfo, RenderGraph, SizeClass
from granite_tpu.math.muglm import look_at_matrix, perspective
from granite_tpu.parallel import band_cull_setup as jax_band_cull
from granite_tpu.parallel import make_tile_mesh as jax_mesh
from granite_tpu.parallel import shard_frame_step as jax_shard
from granite_tpu.renderer.scene_renderer import pack_scene, \
    transform_vertices
from granite_tpu.scene.mesh_util import sphere_mesh
from granite_tpu.scene.scene import Scene
from granite_tpu.scene.scene_formats import NodeData, SceneInfo
from granite_tpu_torch.ops.raster import TriangleSetup
from granite_tpu_torch.ops.raster_binned import rasterize_binned
from granite_tpu_torch.parallel import band_cull_setup, make_tile_mesh
from granite_tpu_torch.parallel.dryrun import dryrun_rank
from granite_tpu_torch.parallel.launch import RankFailure, spawn_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
W = H = 256
TOY_H, TOY_W = 8 * N, 128
COLOR = [0.25, 0.5, 1.0]
# The JAX test_shard_real_deferred_graph's config, at 128 x 16n.
FRAME_CONFIG = {"renderer": "deferred", "hdrBloom": True,
                "shadowMapResolution": 32,
                "clusteredLightsShadowsResolution": 32}
FRAME_W, FRAME_H = 128, 16 * N
FRAMES = 2
# The luma PSNR gate between the packages' frames (tests/test_torch_slice.py).
GATE_DB = 48.0


def jax_sphere_setup():
    """tests/test_parallel.py's field through the JAX package -> numpy
    arrays of its TriangleSetup."""
    info = SceneInfo()
    rng = np.random.RandomState(2)
    info.meshes = [sphere_mesh(10, 1)]
    nodes = [NodeData(name="root")]
    for i in range(24):
        nodes.append(NodeData(
            name=f"s{i}", meshes=[0],
            translation=np.array([rng.uniform(-3, 3),
                                  rng.uniform(-2.5, 2.5),
                                  rng.uniform(-1, 1)], np.float32),
            scale=np.full(3, 0.35, np.float32)))
    nodes[0].children = list(range(1, len(nodes)))
    info.nodes = nodes
    info.roots = [0]
    packed = pack_scene(info)
    s = Scene()
    for i, nd in enumerate(info.nodes):
        s.create_node(parent=0 if i else -1, translation=nd.translation,
                      rotation=nd.rotation, scale=nd.scale)
    s.update_transform_tree()
    world = jnp.asarray(s.world[:s.num_nodes])
    nmats = jnp.asarray(np.linalg.inv(
        s.world[:s.num_nodes, :3, :3]).transpose(0, 2, 1)
        .astype(np.float32))
    view = look_at_matrix(np.array([0, 0, 8.0]), np.zeros(3), (0, 1, 0))
    proj = perspective(0.9, W / H, 0.1)
    vp = jnp.asarray((proj @ view).astype(np.float32))
    clip, *_ = transform_vertices(packed, world, nmats, vp)
    setup = JR.setup_triangles(clip, packed.indices, W, H)
    return {k: np.asarray(v) for k, v in setup._asdict().items()}


def jax_sharded_frame():
    """The JAX viewer's deferred frame (FRAME_CONFIG at FRAME_W x FRAME_H,
    a still camera, one params, the history carried) through JAX's
    shard_frame_step on make_tile_mesh(N), FRAMES times, as the port's
    frame leg renders it -> (the last backbuffer, its luminance
    history).  The history goes back to the host between frames, so the
    second frame reuses the first one's executable."""
    import jax
    from granite_tpu.app.scene_viewer import SceneViewerApplication
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(FRAME_CONFIG, f)
    try:
        app = SceneViewerApplication(types.SimpleNamespace(
            scene=None, config=f.name, camera_index=-1, bench_scene=False))
    finally:
        os.unlink(f.name)
    app.swapchain_updated(FRAME_W, FRAME_H)
    params = dict(app._build_frame_params(1 / 60, 0.0))
    history = app.graph.initial_history()
    mesh = jax_mesh(N)
    runner = jax_shard(app.graph, mesh)
    with mesh:
        for _ in range(FRAMES):
            out, history = runner(params, history)
            history = jax.device_get(history)
    return np.asarray(out), float(history["luminance"])


def torch_setup(arrays):
    return TriangleSetup(**{k: torch.from_numpy(v.copy())
                            for k, v in arrays.items()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The entry point's process, started first, one 4-rank launch of the
    raster, toy and frame legs beside it, and the JAX sharded frame in
    this process while the ranks run."""
    arrays = jax_sphere_setup()
    entry = subprocess.Popen(
        [sys.executable, "-m", "granite_tpu_torch.parallel", "--ranks", "2",
         "--device", "cpu", "--raster-size", "256x256"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        legs = {"raster": ("raster", dict(arrays=arrays, width=W, height=H)),
                "toy": ("toy", dict(height=TOY_H, width=TOY_W,
                                    color=COLOR)),
                "frame": ("frame", dict(cfg=FRAME_CONFIG, width=FRAME_W,
                                        height=FRAME_H, frames=FRAMES))}
        with ThreadPoolExecutor(1) as pool:
            launch = pool.submit(
                spawn_ranks, N, dryrun_rank, legs, backend="gloo",
                device="cpu", tmpdir=str(tmp_path_factory.mktemp("ranks")))
            jax_frame = jax_sharded_frame()
            ranks = launch.result()
        out, _ = entry.communicate(timeout=300)
    finally:
        if entry.poll() is None:
            entry.kill()
            entry.wait()
    return dict(arrays=arrays, ranks=ranks, entry=(entry.returncode, out),
                jax_frame=jax_frame)


@pytest.mark.parametrize("band", range(N))
def test_band_cull_setup_bit_equal_to_jax(run, band):
    arrays = run["arrays"]
    band_h = H // N
    ref = jax_band_cull(JR.TriangleSetup(**{
        k: jnp.asarray(v) for k, v in arrays.items()}), band * band_h,
        band_h)
    got = band_cull_setup(torch_setup(arrays), band * band_h, band_h)
    for name in JR.TriangleSetup._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name


def test_sharded_raster_equals_unsharded(run):
    arrays = run["arrays"]
    ranks = [r["raster"] for r in run["ranks"]]
    d_ref, t_ref = rasterize_binned(torch_setup(arrays), W, H)
    assert (t_ref >= 0).sum() > 0.1 * W * H
    assert np.array_equal(ranks[0]["depth"], d_ref.numpy())
    assert np.array_equal(ranks[0]["tri"], t_ref.numpy())
    # each band's count is JAX's band cull's; the JAX test's gates
    band_h = H // N
    jax_setup = JR.TriangleSetup(**{k: jnp.asarray(v)
                                    for k, v in arrays.items()})
    want = [int(jax_band_cull(jax_setup, b * band_h, band_h).valid.sum())
            for b in range(N)]
    for r in ranks:
        assert r["counts"].tolist() == want
        assert r["b1_launches"] == 0          # the plain version on a CPU
        for k in ("visible_overflow", "huge_overflow", "clamped_entries"):
            assert not r["stats"][k].any(), k
    total = int(arrays["valid"].sum())
    assert sum(want) < 2.0 * total
    assert max(want) <= max(3.0 * total / N, 64)


def test_toy_graph_matches_jax_shard_frame_step(run):
    import jax
    g = RenderGraph()
    g.set_backbuffer_dimensions(TOY_W, TOY_H)
    info = AttachmentInfo(size_class=SizeClass.ABSOLUTE, size_x=TOY_W,
                          size_y=TOY_H, channels=3)
    g.add_pass("shade").add_color_output("img", info).set_execute(
        lambda ctx: {"img": jnp.broadcast_to(
            ctx.params["color"], (TOY_H, TOY_W, 3)) * 1.0})
    g.add_pass("post").add_texture_input("img") \
        .add_color_output("out", info) \
        .set_execute(lambda ctx: {
            "out": ctx.input("img") / (1e-6 + ctx.input("img").mean())})
    g.set_backbuffer_source("out")
    g.bake()
    mesh = jax_mesh(N)
    assert len(jax.devices()) >= N
    with mesh:
        ref, _ = jax_shard(g, mesh)({"color": jnp.array(COLOR)},
                                    g.initial_history())
    ranks = [r["toy"] for r in run["ranks"]]
    for r in ranks:
        assert r["rows"].shape == (TOY_H // N, TOY_W, 3)
        assert r["placement"] == {"shade": "banded", "post": "banded"}
        assert r["collectives"]["all_reduce"] == 1
        assert r["collectives"]["all_gather"] == 0
    got = np.concatenate([r["rows"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)


def test_deferred_frame_matches_unsharded(run):
    ranks = [r["frame"] for r in run["ranks"]]
    r0 = ranks[0]
    assert r0["frame"].shape == (FRAME_H, FRAME_W, 4)
    diff = np.abs(r0["frame"].astype(int) - r0["reference"].astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())
    lums = {r["luminance"] for r in ranks}
    assert len(lums) == 1
    assert lums.pop() == pytest.approx(r0["reference_luminance"], abs=1e-5)
    for r in ranks:
        assert r["band_rows"] == FRAME_H // N
        for f in r["frames"]:
            assert f["collectives"]["all_reduce"] == 1
            assert f["collectives"]["all_gather"] >= 1
        assert r["placement"]["bloom-threshold"] == "banded"
        assert r["placement"]["luminance"] == "reduced"
        assert r["placement"]["tonemap"] == "banded"
        assert r["placement"]["lighting"] == "whole"
        # bloom-d0's 16 rows divide by 4: its history is banded
        assert r["history_rows"]["bloom-d0"] == FRAME_H // 4 // N


def test_deferred_frame_matches_jax_shard_frame_step(run):
    """Rank 0's gathered frame against the JAX viewer's frame sharded by
    JAX's shard_frame_step over 4 devices, at the slice's gate between
    the packages; every rank's luminance history against JAX's within
    1e-5 (the JAX mean is one reduction, the port's a sum and count a
    band plus an all_reduce)."""
    ref, ref_lum = run["jax_frame"]
    ranks = [r["frame"] for r in run["ranks"]]
    got = ranks[0]["frame"]
    assert got.shape == ref.shape == (FRAME_H, FRAME_W, 4)
    assert psnr(got, ref) >= GATE_DB
    for r in ranks:
        assert r["luminance"] == pytest.approx(ref_lum, abs=1e-5)


def test_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(RankFailure, match="rank 1 raised") as err:
        spawn_ranks(2, dryrun_rank, {}, 1, backend="gloo", device="cpu",
                    tmpdir=str(tmp_path))
    assert "DryrunFailure" in str(err.value)
    assert "Traceback" in str(err.value)


def test_backend_and_device_checks(monkeypatch):
    with pytest.raises(ValueError, match="nccl"):
        make_tile_mesh(torch.cuda.device_count() + 1, backend="nccl",
                       device="cuda")
    with pytest.raises(ValueError, match="nccl"):
        spawn_ranks(torch.cuda.device_count() + 1, dryrun_rank, {},
                    backend="nccl", device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_tile_mesh(2, backend="gloo", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        spawn_ranks(2, dryrun_rank, {}, backend="gloo", device="cuda")


def test_entry_point_exits_zero(run):
    rc, out = run["entry"]
    assert rc == 0, out
    assert "parallel dryrun over 2 ranks: OK" in out


@pytest.mark.parametrize("in_hw, out_hw", [
    ((40, 48), (40, 48)),        # same size
    ((40, 48), (20, 24)),        # 2:1, the threshold's half-res reduce
    ((9, 12), (72, 96)),         # integer upsample, the tonemap's bloom
    ((30, 40), (17, 23)),        # the bilinear tap form
])
def test_resize_rows_equal_the_whole_resize(in_hw, out_hw):
    """A row window of ops/hdr.resize_bilinear is bit-equal to those rows
    of the whole resize (bands not aligned to the upsample's factor)."""
    from granite_tpu_torch.ops import hdr as HDR
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.random(in_hw + (4,), dtype=np.float32) * 4)
    whole = HDR.resize_bilinear(img, *out_hw)
    h = out_hw[0]
    for y0, y1 in ((0, h // 4), (h // 4, h // 2 + 1), (h - 3, h)):
        band = HDR.resize_bilinear(img, *out_hw, rows=(y0, y1))
        assert torch.equal(band, whole[y0:y1]), (y0, y1)


def test_threshold_and_tonemap_rows_equal_the_whole():
    from granite_tpu_torch.ops import hdr as HDR
    rng = np.random.default_rng(6)
    hdr = torch.from_numpy(rng.random((64, 96, 3), dtype=np.float32) * 8)
    bloom = torch.from_numpy(rng.random((8, 12, 4), dtype=np.float32))
    avg = torch.tensor(0.7)
    thresh = HDR.bloom_threshold(hdr, avg, 32, 48)
    ldr = HDR.tonemap(hdr, bloom, torch.tensor(0.3))
    for band in range(4):
        assert torch.equal(HDR.bloom_threshold(
            hdr, avg, 32, 48, rows=(8 * band, 8 * band + 8)),
            thresh[8 * band:8 * band + 8])
        assert torch.equal(HDR.tonemap(
            hdr, bloom, torch.tensor(0.3), rows=(16 * band, 16 * band + 16)),
            ldr[16 * band:16 * band + 16])
