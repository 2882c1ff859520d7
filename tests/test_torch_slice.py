"""The port's slices end to end on the CPU: golden configs rendered by
granite_tpu_torch (every kernel through its plain version) against the
JAX render and the committed golden PNGs (48 dB luma gate,
tests/test_golden_images.py), plus the copied scene builders and
pack_scene held equal to the JAX package's originals."""

import json
import os
import tempfile
import types
from dataclasses import MISSING, fields, is_dataclass

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from golden_utils import (
    CONFIGS, FRAMES, GOLDEN_DIR, SIZE, TIME_STEP, psnr, render_config,
)
from granite_tpu.app.bench_scene import build_bench_scene as jax_bench
from granite_tpu.app.scene_viewer import (
    build_default_test_scene as jax_test_scene,
)
from granite_tpu.ops import hdr as JH
from granite_tpu.renderer.scene_renderer import pack_scene as jax_pack
from granite_tpu.utils.image_io import load_image
from granite_tpu_torch import convert
from granite_tpu_torch.app import bench_scene as TB
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.graph.render_graph import RenderGraphError
from granite_tpu_torch.ops import hdr as TH
from granite_tpu_torch.renderer.scene_renderer import pack_scene

GATE_DB = 48.0


def _render_port(cfg, device="cpu"):
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    app = SceneViewerApplication(types.SimpleNamespace(
        config=f.name, bench_scene=False),
        device=device)
    app.swapchain_updated(*SIZE)
    out = None
    for i in range(FRAMES):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
    return out.cpu().numpy()


# The golden configs plus two sets of the other knob values the port
# implements (graph without shadow-main / bloom; shorter bloom chain,
# fixed exposure, factor-only materials, full-res cluster shadows).
# forward_vsm_fxaa keeps materialTileSampler at its default, so both
# packages take the classic per-pixel VSM route on the CPU (the JAX
# tiled route there is the slow interpret-mode Pallas sampler).
SLICE_CONFIGS = {
    "deferred_hdr": CONFIGS["deferred_hdr"],
    "forward_vsm_fxaa": CONFIGS["forward_vsm_fxaa"],
    "no_bloom_no_shadows": {
        "renderer": "deferred", "hdrBloom": False,
        "directionalLightShadows": False, "clusteredLightsShadows": False},
    "knobs": {
        "renderer": "deferred", "hdrBloom": True, "hdrBloomDepth": 4,
        "hdrBloomDynamicExposure": False, "materialTextures": False,
        "shadowMapResolution": 64, "clusteredLightsShadowsResolution": 32,
        "clusteredLightsShadowsHalfRes": False},
}


@pytest.mark.parametrize("name", sorted(SLICE_CONFIGS))
def test_slice_matches_jax_render(name):
    got = _render_port(SLICE_CONFIGS[name])
    ref = render_config(SLICE_CONFIGS[name])
    assert got.shape == ref.shape == (SIZE[1], SIZE[0], 4)
    assert got.dtype == np.uint8
    assert psnr(got, ref) >= GATE_DB


def test_slice_matches_golden_png():
    got = _render_port(CONFIGS["deferred_hdr"])
    golden = load_image(os.path.join(GOLDEN_DIR, "deferred_hdr.png"))
    assert psnr(got, golden) >= GATE_DB
    rgb = got[..., :3].astype(np.float32)
    assert np.isfinite(rgb).all() and 1.0 < rgb.mean() < 250.0


@pytest.mark.parametrize("name", ["forward_shadow", "forward_vsm_fxaa",
                                  "deferred_smaa"])
def test_port_render_matches_golden_png(name):
    """Port-only renders (no JAX compile) of the forward graph, VSM +
    FXAA and SMAA against their committed goldens."""
    got = _render_port(CONFIGS[name])
    golden = load_image(os.path.join(GOLDEN_DIR, f"{name}.png"))
    assert got.shape == golden.shape
    assert psnr(got, golden) >= GATE_DB


def test_forward_graph_passes():
    app = SceneViewerApplication(types.SimpleNamespace(
        config=None, bench_scene=False), device="cpu")
    app.config.directional_light_shadows_vsm = True
    app.config.post_aa = "fxaa"
    app.config.shadow_map_resolution = 64
    app.config.clustered_lights_shadows = False
    app.swapchain_updated(*SIZE)
    order = app.graph._order
    assert "forward" in order and "gbuffer" not in order
    assert "lighting" not in order
    assert order.index("shadow-main") < order.index("forward") \
        < order.index("tonemap") < order.index("fxaa")
    params = app.build_frame_params(TIME_STEP)
    moments = params["static_vsm_moments"]
    s = int(app.config.shadow_map_resolution)
    assert moments.shape == (s, s, 2) and moments.dtype == torch.float32


def _same(a, b, path="info"):
    if is_dataclass(a):
        # a is the JAX package's record, b the port's copy of it: every
        # field of the copy matches, and a field the copy left out would
        # hold its default (none is left out: MeshData keeps the meshlet
        # fields since the port renders meshlet-encoded meshes).
        assert type(a).__name__ == type(b).__name__, path
        kept = {f.name for f in fields(b)}
        for f in fields(a):
            if f.name in kept:
                _same(getattr(a, f.name), getattr(b, f.name),
                      f"{path}.{f.name}")
            else:
                default = f.default if f.default is not MISSING \
                    else f.default_factory()
                _same(getattr(a, f.name), default, f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("builder", ["bench", "test"])
def test_scene_builders_match(builder):
    if builder == "bench":
        _same(jax_bench(), TB.build_bench_scene())
    else:
        _same(jax_test_scene(), TB.build_default_test_scene())


def test_pack_scene_matches():
    ref = jax_pack(jax_test_scene())
    got = pack_scene(TB.build_default_test_scene())
    for name, arr in ref.device_arrays().items():
        want = np.asarray(arr)
        have = getattr(got, name).numpy()
        assert have.dtype == want.dtype and np.array_equal(have, want), name
    for name in ("obj_node", "obj_aabb_min", "obj_aabb_max", "obj_flags"):
        assert np.array_equal(getattr(ref, name), getattr(got, name)), name
    for name in ("num_objects", "num_nodes", "num_static_verts",
                 "has_normal_maps", "has_mr_textures", "has_emissive"):
        assert getattr(ref, name) == getattr(got, name), name
    # and the JAX-side scene converts into the same port structure
    conv = convert.packed_scene(ref)
    assert torch.equal(conv.bundles, got.bundles)


def test_hdr_chain_ops_match():
    rng = np.random.RandomState(3)
    img = (rng.uniform(0, 4, (72, 128, 3)) ** 2).astype(np.float32)
    j, t = jnp.asarray(img), torch.as_tensor(img)
    th = np.asarray(JH.bloom_threshold(j, 1.3, 36, 64))
    assert np.allclose(th, TH.bloom_threshold(t, 1.3, 36, 64).numpy(),
                       rtol=1e-5, atol=1e-5)
    tj, tt = jnp.asarray(th), torch.tensor(th)
    for oh, ow in ((18, 32), (9, 16), (4, 8)):     # 2:1 and tap paths
        a = np.asarray(JH.bloom_downsample(tj[:oh * 2, :ow * 2], oh, ow))
        b = TH.bloom_downsample(tt[:oh * 2, :ow * 2], oh, ow).numpy()
        assert np.allclose(a, b, rtol=1e-5, atol=1e-5)
    a = np.asarray(JH.bloom_downsample(tj, 17, 31))
    assert np.allclose(a, TH.bloom_downsample(tt, 17, 31).numpy(),
                       rtol=1e-5, atol=1e-5)
    for oh, ow in ((72, 128), (40, 70)):
        a = np.asarray(JH.bloom_upsample(tj, oh, ow))
        b = TH.bloom_upsample(tt, oh, ow).numpy()
        assert np.allclose(a, b, rtol=1e-5, atol=1e-5)
    small = tj[:9, :16]
    a = np.asarray(JH.tonemap(j, small, jnp.float32(0.4)))
    b = TH.tonemap(t, tt[:9, :16], torch.tensor(0.4)).numpy()
    assert np.allclose(a, b, rtol=1e-5, atol=1e-5)
    lum_j = float(JH.average_log_luminance(tj, jnp.float32(0.2),
                                           jnp.float32(1 / 60)))
    lum_t = float(TH.average_log_luminance(tt, torch.tensor(0.2), 1 / 60))
    assert abs(lum_j - lum_t) < 1e-5


def test_unsupported_knob_raises():
    with pytest.raises(NotImplementedError):
        _render_port({**CONFIGS["deferred_hdr"], "fusedShade": False})
    # (textureStreaming renders: tests/test_torch_streaming.py)
    for knob in ({"rasterMaxVisible": "half"}, {"envTileSampler": False},
                 {"binPlanCache": "true"}):
        with pytest.raises(NotImplementedError):
            _render_port({**CONFIGS["forward_vsm_fxaa"], **knob})


def test_graph_rejects_unwritten_input():
    from granite_tpu_torch.graph.render_graph import RenderGraph
    g = RenderGraph()
    g.add_pass("a").add_texture_input("nope").add_color_output(
        "backbuffer").set_execute(lambda ctx: {})
    g.set_backbuffer_source("backbuffer")
    with pytest.raises(RenderGraphError):
        g.bake()
