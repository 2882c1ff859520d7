"""No module whose top-level name is jax, jaxlib, flax or granite_tpu is
loaded on the card path, compared by whole top-level names: the port's
name begins with the JAX package's and is not it."""

import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

CARD_PATH = f"""
import sys, json, types
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import run
from gbench import cell, roofline, trace, timing
import plainref.frame
import granite_tpu_torch.app.scene_viewer, granite_tpu_torch.scene_export
for m in run.load_json({ROOT!r}, "BENCHMARK.json")["per_layer"]:
    run.reader(m["name"])
bad = run.forbidden_modules()
sys.modules["granite_tpu_torchx"] = types.ModuleType("granite_tpu_torchx")
sys.modules["jaxlib.xla"] = types.ModuleType("jaxlib.xla")
print(json.dumps([bad, run.forbidden_modules()]))
"""


def test_card_path_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", CARD_PATH],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    bad, planted = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    # a planted jaxlib.xla is found by its top-level name; the port's
    # name (and one that merely starts with it) is not
    assert planted == ["jaxlib"]


def test_run_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                          "--workload", "deferred_hdr.orbit_2160p",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
