from fem_tpu_torch.solver import cg, direct, stepper  # noqa: F401
