from fem_tpu_torch.ops import elements  # noqa: F401
