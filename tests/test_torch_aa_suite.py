"""BASELINE configs 2 and 4 in the port against the JAX package on the CPU:
the TAA family's members that no golden image locks (smaaT2X, fxaa2phase
and taa-extreme on the deferred graph) and the glTF viewer's forward PCF
frame (config 2's knobs) on a glTF file that both viewers load.

Each render is 2 frames at 128x72 (tests/golden_utils.py's size and
step), render_frame then post_frame as golden_utils.render_config runs
the JAX viewer.  Tolerance: luma PSNR >= 48 dB, the golden images' gate
(tests/test_golden_images.py)."""

import json
import types

import numpy as np
import pytest
import torch

from golden_utils import CONFIGS, FRAMES, SIZE, TIME_STEP, psnr, render_config
from granite_tpu.app.scene_viewer import SceneViewerApplication as JaxViewer
from granite_tpu_torch.app.bench_scene import build_default_test_scene
from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
from granite_tpu_torch.scene_export import export_gltf

GATE_DB = 48.0
# The TAA family's members beside taa (deferred_taa_fog's golden) and
# taaFSR2 (deferred_fsr2's): TAA then SMAA, TAA then FXAA, and TAA over
# the 16-phase jitter table.
TEMPORAL_AA = ("smaaT2X", "fxaa2phase", "taa-extreme")
# BASELINE config 2: the forward renderer with the 2x2 PCF sun term (no
# VSM), no bloom, no clustered light shadows, no post AA; the shadow map
# at the goldens' 64^2.
FORWARD_PCF = {**CONFIGS["forward_shadow"], "postAA": "none"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process (several xdist workers share
    the cores; see tests/test_torch_ocean.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(app):
    """FRAMES fixed-step frames at SIZE -> the last backbuffer (numpy)."""
    app.swapchain_updated(*SIZE)
    out = None
    for i in range(FRAMES):
        out = app.render_frame(TIME_STEP, i * TIME_STEP)
        app.post_frame()
    return np.asarray(out)


def _args(config_path: str, scene=None):
    return types.SimpleNamespace(config=config_path, bench_scene=False,
                                 quirks=None, scene=scene, camera_index=-1)


def _config_file(tmp_path, cfg: dict) -> str:
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.mark.parametrize("aa", TEMPORAL_AA)
def test_temporal_post_aa_matches_jax(aa, tmp_path):
    """deferred_taa_fog without the fog volume (as
    test_torch_temporal.test_every_temporal_post_aa_renders renders it)
    under each of the three modes: the jitter table, the TAA resolve and,
    for the two-phase modes, the LDR pass after the tonemap."""
    cfg = {**CONFIGS["deferred_taa_fog"], "postAA": aa,
           "volumetricFog": False}
    app = SceneViewerApplication(_args(_config_file(tmp_path, cfg)),
                                 device="cpu")
    got = _frames(app)
    assert app._jitter.phase == FRAMES
    ref = render_config(cfg)
    assert got.shape == ref.shape == (SIZE[1], SIZE[0], 4)
    assert psnr(got, ref) >= GATE_DB


def test_forward_pcf_gltf_matches_jax(tmp_path):
    """Config 2's knobs on the test scene written as .gltf by the port's
    exporter (KHR_lights_punctual for its lights) and loaded through
    `scene=` by both viewers, the camera framing the bounds: the same
    triangles and lights in both, and the frame at the gate."""
    scene = str(tmp_path / "test.gltf")
    export_gltf(build_default_test_scene(), scene)
    config = _config_file(tmp_path, FORWARD_PCF)
    port = SceneViewerApplication(_args(config, scene), device="cpu")
    ref_app = JaxViewer(_args(config, scene))
    assert not port.config.directional_light_shadows_vsm
    n_lights = len(build_default_test_scene().lights)
    assert len(port.info.lights) == len(ref_app.info.lights) == n_lights
    assert int(port.packed.indices.shape[0]) \
        == int(np.asarray(ref_app.packed.indices).shape[0])
    got = _frames(port)
    assert "forward" in port.graph._order
    assert not any(p in port.graph._order for p in ("fxaa", "smaa",
                                                    "taa-resolve"))
    ref = _frames(ref_app)
    assert got.shape == ref.shape == (SIZE[1], SIZE[0], 4)
    assert psnr(got, ref) >= GATE_DB
