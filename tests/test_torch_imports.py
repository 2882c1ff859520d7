"""The port never imports jax or the JAX package (granite_tpu), directly or
transitively: it keeps its own copies of the host modules it needs."""

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
    # the ocean, terrain, decal and meshlet modules and the stat sink
    # (the native codec's loader included) are among them
    assert {f"granite_tpu_torch.{m}" for m in (
        "core.stats", "native", "ops.decals", "ops.fft", "ops.ocean",
        "renderer.ground", "renderer.ocean")} <= set(lines["NAMES"].split())
    assert lines["JAX"] == "[]"
    assert lines["GRANITE_TPU"] == "[]"
