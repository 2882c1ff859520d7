"""Port of granite_tpu/ops: plain PyTorch for the dense math, hand-written
CUDA kernels (csrc/) where the reference had Pallas kernels."""
