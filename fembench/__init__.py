"""fembench: the benchmark of fem_tpu_torch on an NVIDIA H100 (see PERF.md)."""
