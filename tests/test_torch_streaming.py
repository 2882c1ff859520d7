"""Texture streaming in the port (assets/streaming.py, the AssetManager
copy, pack_scene's texture_streaming and the viewer's post_frame latch)
against the JAX package.

The scene: the golden test scene with four images a material (base
colour, metallic-roughness, normal, emissive; tests/streaming_fixtures.py)
written as glTF, once with `.gtpx` sidecars (base colour BC7, BC3, RGBA8
and BC7 by material, metallic-roughness BC1, normal BC5, emissive BC6H)
and once without.  Residency is made deterministic with one background
worker a package and ThreadGroup.wait_idle() between latches: no sleeps.

Tolerances: bundle arrays bit-equal to the JAX streamer's after every
latch, with and without sidecars (the decode is the same C++ and numpy);
the managers' decisions (resident set, evictions, current_cost) equal
after every iterate(); the 128x72 deferred frame after residency at the
golden images' 48 dB luma gate against the JAX viewer's.
"""

import json
import types

import numpy as np
import pytest
import torch

import streaming_fixtures as SF
from golden_utils import psnr
from granite_tpu.app.scene_viewer import (
    SceneViewerApplication as JaxViewer,
)
from granite_tpu.renderer.scene_renderer import pack_scene as jax_pack
from granite_tpu.scene.gltf import GLTFParser as JaxParser
from granite_tpu.threading_ import thread_group as jax_threads
from granite_tpu_torch.app.bench_scene import build_default_test_scene
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.renderer.scene_renderer import pack_scene
from granite_tpu_torch.scene.gltf import GLTFParser
from granite_tpu_torch.threading_ import thread_group as port_threads

GATE_DB = 48.0
TEXTURE_SIZE = 32                 # the strips' base size
IMAGE_SIZE = 48                   # the images, resized to TEXTURE_SIZE
SEED = 17
BASE_FORMATS = ("bc7", "bc3", "rgba8", "bc7")
# the golden deferred config, textures streamed
CONFIG = {"renderer": "deferred", "hdrBloom": True, "shadowMapResolution": 64,
          "clusteredLightsShadowsResolution": 64, "textureStreaming": True}
STEP = 1.0 / 60.0


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


@pytest.fixture
def workers(monkeypatch):
    """One background worker for each package's streamer, so that
    decodes finish in the order they were kicked and the JAX
    wait_idle's barrier runs after them.  -> (jax, port) groups."""
    jax_tg = jax_threads.ThreadGroup(num_workers=1, num_background=1)
    port_tg = port_threads.ThreadGroup(num_workers=1, num_background=1)
    monkeypatch.setattr(jax_threads.ThreadGroup, "_instance", jax_tg)
    monkeypatch.setattr(port_threads.ThreadGroup, "_instance", port_tg)
    yield jax_tg, port_tg
    jax_tg.shutdown()
    port_tg.shutdown()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = {}
    for name, sidecars in (("sidecars", True), ("no_sidecars", False)):
        d = tmp_path_factory.mktemp(name)
        out[name] = SF.write_textured_scene(
            build_default_test_scene(), str(d), "textured.gltf", IMAGE_SIZE,
            SEED, sidecars=sidecars, base_formats=BASE_FORMATS)["path"]
    cfg = tmp_path_factory.mktemp("cfg") / "cfg.json"
    cfg.write_text(json.dumps(CONFIG))
    out["config"] = str(cfg)
    return out


def _packs(path: str, budget=None):
    jax = jax_pack(JaxParser(path).get_scene(), texture_size=TEXTURE_SIZE,
                   texture_streaming=True, texture_budget=budget)
    port = pack_scene(GLTFParser(path).get_scene(),
                      texture_size=TEXTURE_SIZE, texture_streaming=True,
                      texture_budget=budget)
    return jax, port


def _same(jax_bundles, port_bundles) -> bool:
    a = np.asarray(jax_bundles)
    b = port_bundles.numpy()
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", ["sidecars", "no_sidecars"])
def test_streamed_bundles_match_jax(scenes, workers, case):
    """Frame 0's all-fallback array and the array after every latch are
    bit-equal to the JAX streamer's; the port writes each latched row
    into the same tensor.  Without sidecars the resident array equals the
    unstreamed pack's."""
    jax_tg, port_tg = workers
    jax, port = _packs(scenes[case])
    assert _same(jax.bundles, port.bundles)
    fallback = port.streamer.fallback_strip()
    assert all(np.array_equal(row.numpy(), fallback) for row in port.bundles)
    bundles = port.bundles
    for i in range(3):
        want = jax.streamer.latch()
        assert port.streamer.latch() is bundles
        assert _same(want, bundles)
        if i == 0:
            # nothing resident yet, but a pending normal map gets its
            # asset's COLOR fallback (white), not frame 0's flat normal
            assert not torch.equal(bundles[0], torch.from_numpy(fallback))
        jax_tg.wait_idle()
        port_tg.wait_idle()
    manager = port.streamer.manager
    assert all(manager.is_resident(a) for a in range(len(manager._assets)))
    # the first latch rewrites every row (no signature yet; its normal
    # slot turns white, as in the JAX streamer), the second the resident
    # images
    assert port.streamer.stats["latched"] == \
        2 * len(port.streamer.bundle_keys)
    if case == "no_sidecars":
        plain = pack_scene(GLTFParser(scenes[case]).get_scene(),
                           texture_size=TEXTURE_SIZE)
        assert torch.equal(bundles, plain.bundles)
    else:
        assert not torch.equal(bundles[0], torch.from_numpy(fallback))


def _count_releases(streamer) -> list:
    released = []
    streamer.manager._inst.release = lambda payload: released.append(1)
    return released


def test_asset_manager_decisions_match_jax(scenes, workers):
    """A budget that holds half the decoded images, 12 frames of latches:
    after each iterate() the resident set, the evictions and current_cost
    are the JAX manager's (last_used ties fall back to the assets' order
    in both), within budget, and the bundles bit-equal."""
    jax_tg, port_tg = workers
    images = 4 * len(build_default_test_scene().materials)
    budget = images // 2 * TEXTURE_SIZE * TEXTURE_SIZE * 16
    jax, port = _packs(scenes["sidecars"], budget)
    jax_released = _count_releases(jax.streamer)
    port_released = _count_releases(port.streamer)
    history = {"jax": [], "port": []}
    for _ in range(12):
        for name, pack, released in (("jax", jax, jax_released),
                                     ("port", port, port_released)):
            before = len(released)
            pack.streamer.latch()
            m = pack.streamer.manager
            history[name].append((
                tuple(a.resident for a in m._assets),
                len(released) - before, m.current_cost))
        assert _same(jax.streamer._bundles, port.bundles)
        jax_tg.wait_idle()
        port_tg.wait_idle()
    assert history["port"] == history["jax"]
    assert all(cost <= budget for _, _, cost in history["port"])
    assert port.streamer.manager.evictions == len(port_released) > 0
    assert max(sum(r) for r, _, _ in history["port"]) == images // 2


def test_worker_exception_reraises_in_the_frame_loop(scenes, workers,
                                                     monkeypatch):
    """A decode that raises on its worker re-raises from the next latch's
    iterate() (the JAX streamer would render the fallback forever)."""
    _jax_tg, port_tg = workers
    _jax, port = _packs(scenes["sidecars"])

    def broken(path, asset_class):
        raise OSError(f"cannot read {path}")

    monkeypatch.setattr(port.streamer.manager._inst, "instantiate", broken)
    port.streamer.latch()
    port_tg.wait_idle()
    with pytest.raises(OSError, match="cannot read img://0"):
        port.streamer.latch()


def _render_resident(app, tg, max_latches: int = 4):
    """Frame 0 (fallbacks), then post_frame until every asset is resident
    (a wait_idle after each), then the frame again.  -> (frame 0, frame)."""
    app.swapchain_updated(128, 72)
    first = np.asarray(app.render_frame(STEP, 0.0))
    manager = app.packed.streamer.manager
    for _ in range(max_latches):
        app.post_frame()
        tg.wait_idle()
        if all(a.resident for a in manager._assets):
            break
    app.post_frame()
    return first, np.asarray(app.render_frame(STEP, 0.0))


def test_streamed_render_matches_jax(scenes, workers):
    """The 128x72 deferred frame of the textured scene, its sidecars
    resident, against the JAX viewer's (48 dB); frame 0 renders the
    fallbacks on both and differs from it."""
    jax_tg, port_tg = workers
    args = types.SimpleNamespace(config=scenes["config"],
                                 scene=scenes["sidecars"], camera_index=-1,
                                 bench_scene=False, quirks=None)
    port = SceneViewerApplication(args, device="cpu")
    assert port.packed.streamer is not None
    port0, port_img = _render_resident(port, port_tg)
    jax0, jax_img = _render_resident(JaxViewer(args), jax_tg)
    assert psnr(port0, jax0) >= GATE_DB
    assert psnr(port_img, jax_img) >= GATE_DB
    changed = np.abs(port_img.astype(int) - port0.astype(int)).max(-1) > 0
    assert changed.sum() > 0.05 * changed.size


def test_texture_budget_mb_sets_the_budget(scenes, tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**CONFIG, "textureBudgetMB": 1.5}))
    app = SceneViewerApplication(types.SimpleNamespace(
        config=str(cfg), scene=scenes["sidecars"], camera_index=-1,
        bench_scene=False), device="cpu")
    assert app.packed.streamer.manager._budget == int(1.5 * 2**20)
