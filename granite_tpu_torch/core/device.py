"""Device probe and numeric policy (counterpart of granite_tpu/core/device.py).

TF32 is switched off for float32 matmuls and cuDNN: vertex transforms
run through matmuls (renderer/scene_renderer.transform_vertices) and
TF32 keeps about three decimal digits, which moves triangle edges and
breaks parity with the JAX reference.

Nothing here falls back: asking for `cuda` without a usable card raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """'cuda' / 'cpu' / torch.device -> torch.device; raises when CUDA is
    requested but absent (no silent CPU continuation)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def nvcc_path() -> str | None:
    """Path of the CUDA compiler (PATH first, then CUDA_HOME and the
    toolkit's default prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def card_identity() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output (one line per
    card); raises when nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def describe() -> dict:
    """Versions and toolchain for logs and the smoke script."""
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc_path(),
            "cuda_available": torch.cuda.is_available()}
    if info["cuda_available"]:
        info["device_name"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
    return info
