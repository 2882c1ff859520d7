"""The benchmark harness of granite_tpu_torch (see benchmark/README.md)."""
