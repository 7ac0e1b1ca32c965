from fem_tpu_torch.models.problem import Block, Problem  # noqa: F401
