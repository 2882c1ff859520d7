"""The port never imports jax or the JAX package (granite_tpu), directly or
transitively: it keeps its own copies of the host modules it needs.  Nor
do chip_smoke.py (every module it imports, at the top or inside its
functions) and the test helpers it loads (golden_utils, gltf_fixtures)."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SRC = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["granite_tpu"] = None  # and any `import granite_tpu...`
import granite_tpu_torch
names = [m.name for m in pkgutil.walk_packages(granite_tpu_torch.__path__,
                                               "granite_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(k for k, v in sys.modules.items()
                if (k == "jax" or k.startswith("jax.")) and v is not None)
print("MODULES", len(names))
print("NAMES", " ".join(names))
print("JAX", loaded)
print("GRANITE_TPU", sorted(k for k in sys.modules
                           if k.startswith("granite_tpu.")))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", SRC], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("MODULES", "NAMES", "JAX",
                                     "GRANITE_TPU")))
    assert int(lines["MODULES"]) >= 20
    # the ocean, terrain, decal and meshlet modules, the stat sink (the
    # native codec's loader included), the occlusion and volume modules,
    # the compile probe, the UI and event copies, the triangle demo and
    # texture streaming's modules (the OS-service copies, the texture
    # codec, the streamer, the debug graph), the video player and its
    # source, input, the renderer suite, hashing, the frame ring, the
    # scene-export texture utils and TMX parser, and the tools (the
    # MLT1 codec's loader in native) are among them
    assert {f"granite_tpu_torch.{m}" for m in (
        "core.stats", "native", "ops.decals", "ops.fft", "ops.ocean",
        "renderer.ground", "renderer.ocean", "scene.gltf",
        "scene.scene_loader", "scene.animation", "scene_export",
        "scene_export.gltf_export", "scene_export.camera_export",
        "utils.timer", "utils.image_compare", "app.video_sink",
        "ops.hiz", "renderer.raster_dispatch",
        "renderer.volumetric_diffuse", "tools",
        "tools.compile_parallel_probe", "ui", "ui.flat_renderer",
        "ui.font", "ui.sprite", "ui.widgets", "event", "event.manager",
        "app.application", "app.triangle_demo", "utils.environment",
        "utils.timeline_trace", "threading_", "threading_.thread_group",
        "filesystem", "filesystem.vfs", "filesystem.asset_manager",
        "native.texture", "assets.streaming", "graph.debug",
        "app.video_player", "app.video_source", "app.input",
        "renderer.suite", "utils.hashing", "core.device",
        "scene_export.texture_utils", "scene_export.tmx_parser",
        "renderer.environment", "tools.image_compare", "tools.gtx_cat",
        "tools.texture_viewer", "tools.image_packer",
        "tools.brdf_lut_generate", "tools.obj_to_gltf",
        "tools.bitmap_to_mesh", "tools.gltf_repacker",
        "tools.convert_equirect_to_environment",
        "tools.convert_cube_to_environment", "tools.sweep_scene",
        "tools.aa_bench", "tools.quality_receipt", "tools.hw_verify",
        # the host subsystems: audio, netfs, the pyro protocol, physics
        # and the ECS
        "audio", "audio.backend", "audio.dsp", "audio.mixer", "network",
        "network.netfs", "video", "video.pyro", "physics",
        "physics.physics_system", "physics.shapes", "scene.ecs",
        # the multi-device framebuffer and its entry point
        "parallel", "parallel.launch", "parallel.framebuffer_sharding",
        "parallel.sharded_raster", "parallel.dryrun", "parallel.__main__")} \
        <= set(lines["NAMES"].split())
    assert lines["JAX"] == "[]"
    assert lines["GRANITE_TPU"] == "[]"


SMOKE_SRC = r"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["granite_tpu"] = None
sys.path.insert(0, "tests")
for name in sys.argv[1:]:
    importlib.import_module(name)
print("LOADED", sorted(k for k, v in sys.modules.items() if v is not None
                       and (k.split(".")[0] in ("jax", "granite_tpu"))))
"""


def _smoke_imports() -> set:
    """Every module chip_smoke.py imports, wherever the import stands."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    return names


def test_chip_smoke_imports_without_jax():
    names = _smoke_imports()
    assert {"gltf_fixtures", "golden_utils", "streaming_fixtures"} <= names
    assert not any(n.split(".")[0] in ("jax", "granite_tpu") for n in names)
    proc = subprocess.run(
        [sys.executable, "-c", SMOKE_SRC, "chip_smoke", *sorted(names)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout.splitlines()
