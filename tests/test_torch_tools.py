"""The port's tools (granite_tpu_torch/tools/) held against the JAX
package's tools (tools/*.py) on seeded inputs: the files they write
byte-equal (image_packer for every LDR format and the .npy HDR path,
texture_viewer's PNG, brdf_lut_generate's .npy/.gtpx/.png, obj_to_gltf,
bitmap_to_mesh and gltf_repacker's glTF, .bin, images and .gtpx
sidecars), their printed output equal (gtx_cat's text, image_compare's
JSON), integrate_brdf within 1e-10 (float64 in the same order on both
sides; measured 0), and image_packer's PNG -> BC6H path on the exact
sRGB EOTF where the JAX tool raises to the power 2.2.

The tools that drive the viewer run on the CPU at 128x72: hw_verify
(exit 0, the chain's frame count in its report) and quality_receipt on
the golden test scene in place of the bench scene with 64^2 shadow maps
(hw_verify on the bench scene took 3 min 46 s on a CPU host with its
2048^2 sun map and 512^2 light atlas, 18.5 s on one thread with 64^2
maps; on the test scene 1.1 s); aa_bench and sweep_scene, each a viewer
process a mode or config, on the test scene without its positional
lights (aa_bench's config keeps the 512^2 atlas: 22.7 s a process), 2
modes or configs of 2 frames, their JSON with the JAX tools' keys."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from golden_utils import CONFIGS
from granite_tpu.utils.image_compare import psnr_channels
from granite_tpu_torch.app import bench_scene
from granite_tpu_torch.native import texture as TX
from granite_tpu_torch.ops.srgb import srgb_to_linear
from granite_tpu_torch.scene.scene_formats import MeshData, NodeData
from granite_tpu_torch.scene_export import export_gltf
from granite_tpu_torch.tools import (
    aa_bench, bitmap_to_mesh, brdf_lut_generate, gltf_repacker, gtx_cat,
    hw_verify, image_compare, image_packer, obj_to_gltf, quality_receipt,
    sweep_scene, texture_viewer,
)
from granite_tpu_torch.utils.image_io import save_png

SEED = 29
SIZE = ("--width", "128", "--height", "72")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process (several xdist workers share
    the cores; see tests/test_torch_ocean.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    """tools/<name>.py of the JAX package (tools/ is not a package)."""
    sys.path.insert(0, "tools")
    try:
        return __import__(name)
    finally:
        sys.path.remove("tools")


def _files(directory) -> dict:
    return {f: open(os.path.join(directory, f), "rb").read()
            for f in sorted(os.listdir(directory))}


def _both(tmp_path, name, port_main, argv_for):
    """Runs the port's and the JAX tool's main with argv_for(out dir) in
    two directories; -> (port's files, JAX's files, port's stdout, JAX's
    stdout) with each directory's path written as OUT."""
    outs = {}
    for side, main in (("port", port_main),
                       ("jax", _jax_tool(name).main)):
        d = tmp_path / side
        d.mkdir()
        outs[side] = (d, main(argv_for(str(d))))
    return outs["port"], outs["jax"]


def _rgba(h, w, seed=SEED, alpha=True):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if not alpha:
        img[..., 3] = 255
    return img


def test_integrate_brdf_matches_jax():
    want = _jax_tool("brdf_lut_generate").integrate_brdf(32, 64)
    got = brdf_lut_generate.integrate_brdf(32, 64, "cpu")
    assert got.dtype == np.float32 and got.shape == (32, 32, 2)
    assert np.abs(got.astype(np.float64) - want).max() <= 1e-10


def test_brdf_tool_files_match_jax(tmp_path):
    def argv(d):
        return ["--output", f"{d}/lut.npy", "--size", "16", "--samples",
                "32", "--gtpx", f"{d}/lut.gtpx", "--png", f"{d}/lut.png"]
    port, jax = _both(tmp_path, "brdf_lut_generate",
                      lambda a: brdf_lut_generate.main([*a, "--device",
                                                        "cpu"]), argv)
    assert port[1] == jax[1] == 0
    assert _files(port[0]) == _files(jax[0])
    assert set(_files(port[0])) == {"lut.npy", "lut.gtpx", "lut.png"}


# case -> (input, flags): PNGs of 29x37 (blocks cut by the edge) without
# mips and 20x28 with (both axes reach 1 texel at the same level, where
# the JAX tool's mips are right: test_image_packer_non_square_mips).
PACK_CASES = {
    "rgba8": ("png 29x37", ["--format", "rgba8"]),
    "bc1 mips": ("png 20x28", ["--format", "bc1", "--mips"]),
    "bc3 mips srgb": ("png 20x28", ["--format", "bc3", "--mips", "--srgb"]),
    "bc4": ("png 29x37", ["--format", "bc4"]),
    "bc5 mips": ("png 20x28", ["--format", "bc5", "--mips"]),
    "bc7": ("png 29x37", ["--format", "bc7"]),
    "bc7 mips": ("png 20x28", ["--format", "bc7", "--mips"]),
    "rgba8 mips": ("png 20x28", ["--format", "rgba8", "--mips"]),
    "bc1 float npy": ("float npy", ["--format", "bc1", "--mips"]),
    "bc7 gray npy": ("gray npy", ["--format", "bc7"]),
    "bc6h npy mips": ("hdr npy", ["--format", "bc6h", "--mips"]),
}


def _pack_input(tmp_path, kind) -> str:
    rng = np.random.default_rng(SEED)
    if kind.startswith("png"):
        h, w = (int(t) for t in kind.split()[1].split("x"))
        path = str(tmp_path / "in.png")
        save_png(path, _rgba(h, w))
    else:
        path = str(tmp_path / "in.npy")
        arr = {"float npy": lambda: rng.uniform(0, 1, (21, 18, 3)),
               "gray npy": lambda: rng.integers(0, 256, (13, 17),
                                                dtype=np.uint8),
               "hdr npy": lambda: rng.uniform(0, 40, (22, 19, 3))
               .astype(np.float32)}[kind]()
        np.save(path, arr)
    return path


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_image_packer_matches_jax(tmp_path, case):
    kind, flags = PACK_CASES[case]
    src = _pack_input(tmp_path, kind)
    jax_packer = _jax_tool("image_packer")
    assert image_packer.main([src, "--output", str(tmp_path / "p.gtpx"),
                              *flags]) == 0
    assert jax_packer.main([src, "--output", str(tmp_path / "j.gtpx"),
                            *flags]) == 0
    assert (tmp_path / "p.gtpx").read_bytes() == \
        (tmp_path / "j.gtpx").read_bytes()


def test_image_packer_non_square_mips(tmp_path):
    """29x37 mips: 3x4 -> 1x2 -> 1x1, each level the box average of the
    last (unrounded); the JAX tool reshapes the 1x2 level into a 1x1 of
    two channels, so its RGBA8 payload ends 2 bytes short."""
    img = _rgba(29, 37)
    src = str(tmp_path / "in.png")
    save_png(src, img)
    argv = [src, "--output", str(tmp_path / "p.gtpx"), "--format", "rgba8",
            "--mips"]
    assert image_packer.main(argv) == 0
    _f, w, h, levels, _fl, payload = TX.gtpx_load(str(tmp_path / "p.gtpx"))
    want, cur = [img], img.astype(np.float64)
    while max(cur.shape[:2]) > 1:
        fy, fx = min(cur.shape[0], 2), min(cur.shape[1], 2)
        hh, ww = cur.shape[0] // fy, cur.shape[1] // fx
        cur = cur[:hh * fy, :ww * fx].reshape(hh, fy, ww, fx, 4) \
            .mean((1, 3))
        want.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))
    assert [lv.shape[:2] for lv in want][-3:] == [(3, 4), (1, 2), (1, 1)]
    assert (w, h, levels) == (37, 29, len(want))
    assert payload == b"".join(lv.tobytes() for lv in want)
    argv[2] = str(tmp_path / "j.gtpx")
    assert _jax_tool("image_packer").main(argv) == 0
    assert len(TX.gtpx_load(argv[2])[5]) == len(payload) - 2


def test_image_packer_png_to_bc6h_uses_the_srgb_eotf(tmp_path):
    """The JAX tool linearizes a PNG for BC6H with pow 2.2; the port uses
    the exact sRGB curve (ops/srgb.srgb_to_linear)."""
    src = str(tmp_path / "in.png")
    img = _rgba(16, 24, alpha=False)
    save_png(src, img)
    assert image_packer.main([src, "--output", str(tmp_path / "p.gtpx"),
                              "--format", "bc6h"]) == 0
    assert _jax_tool("image_packer").main(
        [src, "--output", str(tmp_path / "j.gtpx"), "--format", "bc6h"]) == 0
    _f, w, h, levels, _fl, payload = TX.gtpx_load(str(tmp_path / "p.gtpx"))
    linear = srgb_to_linear(torch.from_numpy(
        img[..., :3].astype(np.float32) / 255.0)).numpy()
    assert (w, h, levels) == (24, 16, 1)
    assert payload == bytes(TX.encode_bc6h(linear))
    pow22 = (img[..., :3].astype(np.float32) / 255.0) ** 2.2
    j_payload = TX.gtpx_load(str(tmp_path / "j.gtpx"))[5]
    assert j_payload == bytes(TX.encode_bc6h(pow22))
    assert payload != j_payload


@pytest.fixture
def gtpx_files(tmp_path):
    """A mipped BC1, an RGBA8 and a mipped BC6H container."""
    png = str(tmp_path / "src.png")
    save_png(png, _rgba(20, 28))
    hdr = str(tmp_path / "src.npy")
    np.save(hdr, np.random.default_rng(SEED).uniform(0, 8, (12, 16, 3))
            .astype(np.float32))
    out = {}
    for name, src, flags in (("bc1", png, ["--format", "bc1", "--mips"]),
                             ("rgba8", png, ["--format", "rgba8"]),
                             ("bc6h", hdr, ["--format", "bc6h", "--mips"])):
        out[name] = str(tmp_path / f"{name}.gtpx")
        assert image_packer.main([src, "--output", out[name], *flags]) == 0
    return out


def test_gtx_cat_text_matches_jax(gtpx_files, capsys):
    paths = list(gtpx_files.values())
    capsys.readouterr()
    assert gtx_cat.main(paths) == 0
    got = capsys.readouterr().out
    assert _jax_tool("gtx_cat").main(paths) == 0
    assert got == capsys.readouterr().out
    assert "level 4: 1x1" in got


@pytest.mark.parametrize("name,level,ext", [
    ("bc1", 1, "png"), ("rgba8", 0, "png"), ("bc6h", 0, "png"),
    ("bc6h", 2, "npy"), ("bc1", 0, "npy")])
def test_texture_viewer_matches_jax(gtpx_files, tmp_path, name, level, ext):
    src = gtpx_files[name]
    argv = [src, "--level", str(level)]
    assert texture_viewer.main([*argv, "--output",
                                str(tmp_path / f"p.{ext}")]) == 0
    assert _jax_tool("texture_viewer").main(
        [*argv, "--output", str(tmp_path / f"j.{ext}")]) == 0
    assert (tmp_path / f"p.{ext}").read_bytes() == \
        (tmp_path / f"j.{ext}").read_bytes()
    assert texture_viewer.main([src, "--level", "9", "--output",
                                str(tmp_path / "x.png")]) == 1


@pytest.mark.parametrize("threshold", ["0", "60"])
def test_image_compare_matches_jax(tmp_path, capsys, threshold):
    a, b = _rgba(24, 40, alpha=False), _rgba(24, 40, SEED + 1, False)
    b[4:12, 5:30] = a[4:12, 5:30]
    for name, img in (("a", a), ("b", b), ("c", _rgba(8, 8))):
        save_png(str(tmp_path / f"{name}.png"), img)
    argv = ["--inputs", str(tmp_path / "a.png"), str(tmp_path / "b.png"),
            "--threshold", threshold]
    capsys.readouterr()
    rc = image_compare.main([*argv, "--diff", str(tmp_path / "pd.png")])
    got = capsys.readouterr().out
    jrc = _jax_tool("image_compare").main(
        [*argv, "--diff", str(tmp_path / "jd.png")])
    assert rc == jrc == (0 if threshold == "0" else 1)
    assert json.loads(got) == json.loads(capsys.readouterr().out)
    assert (tmp_path / "pd.png").read_bytes() == \
        (tmp_path / "jd.png").read_bytes()
    assert image_compare.main(["--inputs", str(tmp_path / "a.png"),
                               str(tmp_path / "c.png")]) == 2


def _write_obj(d) -> str:
    """Two material groups (one textured), a quad fan, negative indices,
    a corner without uv."""
    save_png(os.path.join(d, "kd.png"), _rgba(8, 8))
    with open(os.path.join(d, "m.mtl"), "w") as f:
        f.write("newmtl red\nKd 0.8 0.1 0.1\nNs 100\nd 0.5\n"
                "newmtl tex\nKd 1 1 1\nmap_Kd kd.png\n")
    with open(os.path.join(d, "m.obj"), "w") as f:
        f.write("mtllib m.mtl\n"
                "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                "vn 0 0 1\nvn 0 1 0\n"
                "usemtl red\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
                "usemtl tex\nf -5/-4/-1 -4/-3/-1 -1/-2/-1\n"
                "f 3//2 4//2 5//2\n")
    return os.path.join(d, "m.obj")


def test_obj_to_gltf_matches_jax(tmp_path):
    src = _write_obj(str(tmp_path))

    def argv(d):
        return [src, os.path.join(d, "out.gltf")]
    port, jax = _both(tmp_path, "obj_to_gltf", obj_to_gltf.main, argv)
    assert port[1] == jax[1] == 0
    assert _files(port[0]) == _files(jax[0])


@pytest.mark.parametrize("per_pixel", [False, True])
def test_bitmap_to_mesh_matches_jax(tmp_path, per_pixel):
    img = _rgba(10, 12)
    img[..., 3] = np.where(np.random.default_rng(SEED).uniform(
        size=(10, 12)) < 0.6, 255, 0)
    src = str(tmp_path / "bitmap.png")
    save_png(src, img)

    def argv(d):
        return [src, "--output", os.path.join(d, "mesh.gltf"),
                "--depth", "0.2", "--scale", "2.0"] + \
            (["--per-pixel"] if per_pixel else [])
    port, jax = _both(tmp_path, "bitmap_to_mesh", bitmap_to_mesh.main, argv)
    assert port[1] == jax[1] == 0
    assert _files(port[0]) == _files(jax[0])


def _repack_input(d) -> str:
    """The golden test scene with an opaque base colour, a base colour
    with alpha and a normal map, and an unindexed quad (every vertex of
    its second triangle a duplicate) to weld."""
    info = bench_scene.build_default_test_scene()
    info.images = [_rgba(16, 16, 1, alpha=False), _rgba(16, 8, 2),
                   _rgba(8, 8, 3, alpha=False)]
    info.image_srgb = [True, True, False]
    info.image_paths = [None, None, None]
    info.materials[0].base_color_image = 0
    info.materials[0].normal_image = 2
    info.materials[1].base_color_image = 1
    quad = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0],
                     [0, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    info.meshes.append(MeshData(positions=quad, material=0).finalize())
    info.nodes.append(NodeData(name="quad", meshes=[len(info.meshes) - 1]))
    info.roots.append(len(info.nodes) - 1)
    path = os.path.join(d, "scene.gltf")
    export_gltf(info, path)
    return path


def test_gltf_repacker_matches_jax(tmp_path, capsys):
    src = _repack_input(str(tmp_path))

    def argv(d):
        return ["--input", src, "--output", os.path.join(d, "out.gltf"),
                "--meshlets", "--compress-textures"]
    capsys.readouterr()
    port, jax = _both(tmp_path, "gltf_repacker", gltf_repacker.main, argv)
    out = capsys.readouterr().out.split("wrote ")
    assert port[1] == jax[1] == 0
    files = _files(port[0])
    assert files == _files(jax[0])
    assert {"tex0.gtpx", "tex1.gtpx", "tex2.gtpx"} <= set(files)
    assert [TX.gtpx_load(str(port[0] / f"tex{i}.gtpx"))[0]
            for i in range(3)] == ["bc1", "bc3", "bc5"]
    # printed the same, each with its own directory
    assert out[0].replace(str(port[0]), "OUT") == \
        out[1].split("\n", 1)[1].replace(str(jax[0]), "OUT")
    assert "meshlets" in out[0] and "% saved" in out[0]


def test_dedup_welds_first_occurrences():
    """np.unique's first indices are the JAX loop's first occurrences."""
    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 4, (40, 8)).astype(np.float32)
    md = types.SimpleNamespace(positions=base[:, :3].copy(),
                               normals=base[:, 3:6].copy(),
                               uvs=base[:, 6:].copy(), tangents=None,
                               indices=rng.integers(0, 40, (30, 3)))
    ref = types.SimpleNamespace(**vars(md))
    assert gltf_repacker.dedup_mesh(md) == \
        _jax_tool("gltf_repacker").dedup_mesh(ref)
    for k in ("positions", "normals", "uvs", "indices"):
        assert np.array_equal(getattr(md, k), getattr(ref, k))


@pytest.fixture
def test_scene_as_bench(monkeypatch):
    """build_bench_scene returns the golden test scene."""
    monkeypatch.setattr(bench_scene, "build_bench_scene",
                        bench_scene.build_default_test_scene)


def test_hw_verify_on_cpu(tmp_path, test_scene_as_bench):
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(CONFIGS["deferred_hdr"], f)
    out = str(tmp_path / "out")
    assert hw_verify.main([*SIZE, "--frames", "3", "--out", out,
                           "--config", cfg, "--device", "cpu"]) == 0
    with open(os.path.join(out, "hw_verify.json")) as f:
        report = json.load(f)
    assert report["ok"] and not report["failures"]
    assert report["chain_frames"] == report["chain_graph_executes"] == 3
    assert report["chain_b2_launches"] is None     # no kernel on the CPU
    assert os.path.exists(report["png"])


def test_hw_verify_counts_a_short_chain(tmp_path, test_scene_as_bench,
                                        monkeypatch):
    """A chain that renders fewer frames than asked fails check 3."""
    from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
    chained = SceneViewerApplication.render_frames_chained
    monkeypatch.setattr(SceneViewerApplication, "render_frames_chained",
                        lambda self, ft, t0, n, **kw:
                        chained(self, ft, t0, n - 1, **kw))
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(CONFIGS["deferred_hdr"], f)
    out = str(tmp_path / "out")
    assert hw_verify.main([*SIZE, "--frames", "3", "--out", out,
                           "--config", cfg, "--device", "cpu"]) == 1
    with open(os.path.join(out, "hw_verify.json")) as f:
        report = json.load(f)
    assert report["chain_graph_executes"] == 2
    assert any("executed the render graph 2 times" in m
               for m in report["failures"])


def test_quality_receipt_on_cpu(tmp_path, capsys, test_scene_as_bench,
                                monkeypatch):
    monkeypatch.setattr(quality_receipt, "BASE", {
        **quality_receipt.BASE, "shadowMapResolution": 64,
        "clusteredLightsShadowsResolution": 64})
    capsys.readouterr()
    assert quality_receipt.main([*SIZE, "--frames", "2", "--out",
                                 str(tmp_path), "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    receipt = json.loads(line)
    assert set(receipt) == {"lumaPSNRdB", "maxAbsDiff", "pctPixelsChanged",
                            "width", "height"}
    assert (receipt["width"], receipt["height"]) == (128, 72)
    # the half-res trades change the frame
    assert receipt["maxAbsDiff"] > 0 and receipt["lumaPSNRdB"] < 99.0


@pytest.fixture
def lightless_scene(tmp_path, monkeypatch):
    """The golden test scene without its positional lights as glTF; the
    viewer processes run on one intra-op thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    info = bench_scene.build_default_test_scene()
    for nd in info.nodes:
        nd.light = None
    info.lights = []
    path = str(tmp_path / "scene.gltf")
    export_gltf(info, path)
    return path


def test_aa_bench_on_cpu(tmp_path, capsys, lightless_scene):
    capsys.readouterr()
    assert aa_bench.main(["--modes", "none", "fxaa", "--frames", "2",
                          *SIZE, "--scene", lightless_scene, "--outdir",
                          str(tmp_path / "aa"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    results = json.loads(out[out.index("{"):])
    psnr_keys = set(psnr_channels(np.zeros((2, 2, 3)), np.ones((2, 2, 3))))
    assert set(results) == {"none", "fxaa"}
    assert set(results["none"]) == {"averageFrameTimeUs"}
    assert set(results["fxaa"]) == {"averageFrameTimeUs"} | psnr_keys
    assert results["fxaa"]["psnrLuma"] < 99.0


def test_sweep_scene_on_cpu(tmp_path, capsys, lightless_scene):
    configs = []
    for name in ("deferred_hdr", "forward_shadow"):
        configs.append(str(tmp_path / f"{name}.json"))
        with open(configs[-1], "w") as f:
            json.dump(CONFIGS[name], f)
    capsys.readouterr()
    assert sweep_scene.main(["--configs", *configs, "--iterations", "1",
                             "--frames", "2", *SIZE, "--scene",
                             lightless_scene, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    results = json.loads(out[out.index("{"):])
    assert set(results) == set(configs)
    for r in results.values():
        assert set(r) == {"averageFrameTimeUs", "stdev", "iterations"}
        assert len(r["iterations"]) == 1 and r["averageFrameTimeUs"] > 0


def test_viewer_process_failure_raises(tmp_path, lightless_scene):
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        json.dump({"envTileSampler": False}, f)      # refused by the port
    with pytest.raises(RuntimeError, match="viewer exited"):
        sweep_scene.main(["--configs", bad, "--iterations", "1",
                          "--frames", "1", *SIZE, "--scene",
                          lightless_scene, "--device", "cpu"])
