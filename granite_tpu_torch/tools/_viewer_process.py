"""Run the port's headless viewer (python -m
granite_tpu_torch.app.scene_viewer) as a child process, from the current
directory: the tools that sweep configs (sweep_scene, aa_bench) time each
in a fresh process, as the JAX tools do."""

from __future__ import annotations

import subprocess
import sys


def run_viewer(args: list) -> None:
    """Runs the viewer with `args`; raises RuntimeError with the end of
    its output when it exits non-zero."""
    cmd = [sys.executable, "-m", "granite_tpu_torch.app.scene_viewer",
           *args]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"viewer exited {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}")
