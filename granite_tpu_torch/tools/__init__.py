"""Tools of the port (granite_tpu_torch.tools.compile_parallel_probe)."""
