"""The benchmark's plain reference renderer, written for the benchmark in
plain PyTorch from the engine's stated rules (see README.md).  It imports
nothing of granite_tpu_torch, granite_tpu or jax, and shares no code with
the renderer under test."""
