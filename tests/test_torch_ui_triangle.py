"""The port's UI (host copies of granite_tpu/ui, the device-side overlay
composite), its event manager copy, the Application base with the
triangle demo (BASELINE config 1), and the render-target knobs (msaa,
renderTargetFp16), clusteredLightsShadowsVSM and showUi in the viewer,
each against the JAX package on the same inputs.

Tolerances: the UI copies are the same numpy code, so canvases are
equal; composite_overlay 1e-6; resize_bilinear (the tonemap's reduction
of an msaa frame) 1e-6; the triangle demo's 128x72 frames >= 60 dB luma
PSNR against the JAX demo (measured 99 dB: equal bytes).  Viewer
renders: 128x72, the golden test scene, 2 frames, >= 48 dB against the
JAX viewer (measured on the CPU: deferred_hdr + clusteredLightsShadowsVSM
68.77 dB, + msaa 4 + renderTargetFp16 61.49, + msaa 2 63.44;
deferred_taa_fog + showUi 73.66).  Under renderTargetFp16 XLA on the
CPU may keep f32 inside a fused f16 chain where torch rounds after each
op; the gate is not loosened for it."""

import json
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import CONFIGS, FRAMES, SIZE, TIME_STEP, psnr, \
    render_config
from granite_tpu.app.triangle_demo import TriangleApplication as JaxTriangle
from granite_tpu.event import manager as JEV
from granite_tpu.ops import hdr as JH
from granite_tpu.ui import flat_renderer as JFR
from granite_tpu.ui import font as JFont
from granite_tpu.ui import sprite as JSP
from granite_tpu.ui import widgets as JW
from granite_tpu_torch.app import triangle_demo as TD
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.event import manager as TEV
from granite_tpu_torch.ops import hdr as TH
from granite_tpu_torch.ui import flat_renderer as TFR
from granite_tpu_torch.ui import font as TFont
from granite_tpu_torch.ui import sprite as TSP
from granite_tpu_torch.ui import widgets as TW

SEED = 12
GATE_DB = 48.0
TRIANGLE_GATE_DB = 60.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process (several xdist workers share
    the cores; see tests/test_torch_ocean.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ui_tree(W, width: int, height: int, clicks: list):
    """A stats window, a packed row of buttons, a slider and an image,
    built with one package's widgets module."""
    ui = W.UIManager(width, height)
    win = ui.add_child(W.Window("granite tpu"))
    win.add_child(W.Label(" 16.7 ms 9216 tris"))
    row = win.add_child(W.HorizontalPacking())
    row.add_child(W.ClickButton("Go", on_click=lambda: clicks.append(1)))
    row.add_child(W.ToggleButton("Fog"))
    win.add_child(W.Slider("exp", 0.0, 4.0, 1.5))
    img = np.random.default_rng(SEED).uniform(0, 1, (6, 10, 4))
    win.add_child(W.Image(img.astype(np.float32)))
    return ui


def test_widget_trees_render_equal():
    clicks = {"jax": [], "port": []}
    uis = {"jax": _ui_tree(JW, 160, 90, clicks["jax"]),
           "port": _ui_tree(TW, 160, 90, clicks["port"])}
    a, b = uis["jax"].render(), uis["port"].render()
    assert a.shape == b.shape == (90, 160, 4) and b.dtype == np.float32
    assert np.array_equal(a, b) and float(b[..., 3].max()) > 0.5
    # the same pointer events: press the toggle, drag the slider, drag
    # the window by its title bar
    for ui in uis.values():
        row = ui.widgets[0].children[1]
        toggle, slider = row.children[1], ui.widgets[0].children[2]
        ui.render()
        for kind, x, y in (("press", toggle.x + 2, toggle.y + 2),
                           ("release", toggle.x + 2, toggle.y + 2),
                           ("press", slider.x + slider.w - 6, slider.y + 4),
                           ("move", slider.x + 30, slider.y + 4),
                           ("release", slider.x + 30, slider.y + 4),
                           ("press", 12, 10), ("move", 40, 30),
                           ("release", 40, 30)):
            assert ui.filter_input_event(kind, x, y)
    assert not uis["port"].filter_input_event("press", 150, 85)
    a, b = uis["jax"].render(), uis["port"].render()
    assert np.array_equal(a, b)
    assert uis["port"].widgets[0].floating_position == (36.0, 28.0)


def test_sprites_and_text_render_equal():
    canvases = []
    for FR, SP, Font in ((JFR, JSP, JFont), (TFR, TSP, TFont)):
        rng = np.random.default_rng(SEED)       # the same sprites for both
        fr = FR.FlatRenderer(96, 64)
        fr.begin()
        atlas = SP.SpriteAtlas(64)
        ids = [atlas.add(rng.uniform(0, 1, (h, w, 4)).astype(np.float32))
               for h, w in ((8, 12), (20, 30), (9, 40))]
        sr = SP.SpriteRenderer(atlas)
        for i, sid in enumerate(ids):
            sr.queue_sprite(sid, 5 + 20 * i, 3 + 9 * i, layer=2 - i,
                            scale=1.5 if i == 1 else 1.0)
        assert sr.flush(fr) == 3
        fr.render_quad(40, 40, 30, 12, (0.2, 0.4, 0.6, 0.7))
        fr.render_text("AB 12:ms", 2, 50, scale=2)
        font = Font.Font(size=10)
        fr.render_text("fps", 60, 2, font=font)
        canvases.append(fr.flush().copy())
    assert np.array_equal(*canvases)


def test_event_manager_copy_latches():
    logs = []
    for EV in (JEV, TEV):
        EV.EventManager.reset()
        em = EV.EventManager.get()

        class Up(EV.LatchedEvent):
            pass

        class Ping(EV.Event):
            pass

        log = []
        em.register_handler(Ping, lambda e: log.append("ping"))
        em.enqueue(Ping())
        em.enqueue_latched(Up())
        em.register_latch_handler(Up, lambda e: log.append("up"),
                                  lambda e: log.append("down"))
        em.dispatch()
        em.dequeue_all_latched(Up)
        logs.append(log)
        EV.EventManager.reset()
    assert logs[0] == logs[1] == ["up", "ping", "down"]


def test_composite_overlay_matches():
    rng = np.random.default_rng(SEED)
    img = rng.uniform(0, 1, (36, 64, 3)).astype(np.float32)
    ov = rng.uniform(0, 1, (36, 64, 4)).astype(np.float32)
    ov[::3, :, 3] = 0.0
    ref = np.asarray(JFR.composite_overlay(jnp.asarray(img),
                                           jnp.asarray(ov)))
    got = TFR.composite_overlay(torch.as_tensor(img), torch.as_tensor(ov))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-6


@pytest.mark.parametrize("msaa", [2, 4])
def test_msaa_reduction_matches(msaa):
    """The tonemap's reduction of an msaa frame: msaa 4 (2x the size)
    takes the exact 2:1 box form, msaa 2 (1.414x) the bilinear taps, in
    both packages."""
    s = float(np.sqrt(msaa))
    h, w = int(SIZE[1] * s), int(SIZE[0] * s)
    img = np.random.default_rng(SEED).uniform(0, 1, (h, w, 3)) \
        .astype(np.float32)
    ref = np.asarray(JH.resize_bilinear(jnp.asarray(img), SIZE[1], SIZE[0]))
    got = TH.resize_bilinear(torch.as_tensor(img), SIZE[1], SIZE[0]).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    if msaa == 4:
        box = img.reshape(SIZE[1], 2, SIZE[0], 2, 3).mean(axis=(1, 3))
        assert np.abs(got - box).max() <= 1e-6


@pytest.mark.parametrize("elapsed", [0.0, 0.5])
def test_triangle_demo_matches_jax(elapsed):
    jax_app = JaxTriangle()
    jax_app.swapchain_updated(*SIZE)
    app = TD.TriangleApplication(device="cpu")
    app.swapchain_updated(*SIZE)
    ref = np.asarray(jax_app.render_frame(TIME_STEP, elapsed))
    got = app.render_frame(TIME_STEP, elapsed)
    assert got.dtype == torch.uint8 and got.shape == (SIZE[1], SIZE[0], 4)
    assert app.graph._order == ["triangle", "blit"]
    assert psnr(got.numpy(), ref) >= TRIANGLE_GATE_DB


def test_triangle_demo_entry_point(tmp_path):
    """python -m granite_tpu_torch.app.triangle_demo with the JAX demo's
    flags: its PNG and stat JSON."""
    png, stat = tmp_path / "t.png", tmp_path / "s.json"
    assert TD.main(["--width", "64", "--height", "36", "--frames", "2",
                    "--time-step", "0.25", "--device", "cpu",
                    "--png-path", str(png), "--stat", str(stat)]) == 0
    from granite_tpu_torch.utils.image_io import load_image
    img = load_image(str(png))
    assert img.shape[:2] == (36, 64)
    assert json.loads(stat.read_text())["gpu"] == "cpu"


def _render_port(cfg):
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    app = SceneViewerApplication(types.SimpleNamespace(
        config=f.name, bench_scene=False), device="cpu")
    app.swapchain_updated(*SIZE)
    out = None
    for i in range(FRAMES):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
    return app, out.numpy()


VIEWER_CONFIGS = {
    "deferred_hdr clustered VSM": {**CONFIGS["deferred_hdr"],
                                   "clusteredLightsShadowsVSM": True},
    "deferred_hdr msaa 4 fp16": {**CONFIGS["deferred_hdr"], "msaa": 4,
                                 "renderTargetFp16": True},
    "deferred_hdr msaa 2": {**CONFIGS["deferred_hdr"], "msaa": 2},
    "deferred_taa_fog showUi": {**CONFIGS["deferred_taa_fog"],
                                "showUi": True},
}


@pytest.mark.parametrize("name", sorted(VIEWER_CONFIGS))
def test_viewer_target_knobs_match_jax(name):
    cfg = VIEWER_CONFIGS[name]
    app, got = _render_port(cfg)
    ref = render_config(cfg)
    assert got.shape == ref.shape == (SIZE[1], SIZE[0], 4)
    assert psnr(got, ref) >= GATE_DB
    scale = float(np.sqrt(cfg.get("msaa", 1)))
    assert (app._rw, app._rh) == (int(SIZE[0] * scale), int(SIZE[1] * scale))
    res = app.graph._resources
    want = torch.float16 if cfg.get("renderTargetFp16") else torch.float32
    for name_ in ("hdr", "bloom-thresh", "bloom-final"):
        assert res[name_].info.dtype == want
    assert res["depth-main"].info.dtype == torch.float32
    if cfg.get("clusteredLightsShadowsVSM"):
        assert app._cluster_shadow["atlas_flat"].shape[-1] == 8
    if cfg.get("showUi"):
        # the label follows the frame time
        assert app._ui_stats_label.text.startswith(
            f"{TIME_STEP * 1000:5.1f} ms")
        assert app._param_cache[1]["ui_overlay"].shape == (SIZE[1], SIZE[0],
                                                           4)


def test_ssr_at_odd_render_size_raises():
    """msaa 2 renders 181x101; the JAX viewer's SSR fails there
    (granite_tpu/ops/ssr.py:30), so the port refuses the combination."""
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump({**CONFIGS["deferred_ssao_ssr"], "msaa": 2}, f)
    app = SceneViewerApplication(types.SimpleNamespace(
        config=f.name, bench_scene=False), device="cpu")
    with pytest.raises(NotImplementedError, match="ssr"):
        app.swapchain_updated(*SIZE)
    with pytest.raises(NotImplementedError, match="ssr"):
        app.swapchain_updated(128, 70)      # 181x98: still odd
    app.config.msaa = 4                     # 256x144 renders
    app.swapchain_updated(*SIZE)
    assert (app._rw, app._rh) == (256, 144)
