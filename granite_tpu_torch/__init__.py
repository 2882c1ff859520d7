"""granite_tpu_torch — the PyTorch/CUDA port of granite_tpu.

The JAX package (`granite_tpu/`) stays the reference; this package mirrors
its layout (ops/, renderer/, graph/, app/, core/, and the numpy host
copies in math/, scene/, utils/) so each module's counterpart is easy
to find.  Plain tensor code is PyTorch; every Pallas
kernel of the reference is a hand-written CUDA kernel for Hopper
(`csrc/`, built by `kernels/build.py`).  Paths are chosen by the device
of the tensors a function receives: CPU tensors run each kernel's plain
PyTorch version, CUDA tensors launch the kernel or raise.

The package never imports jax or granite_tpu
(tests/test_torch_imports.py).
"""

from .core import device as _device  # noqa: F401  (TF32 policy)
