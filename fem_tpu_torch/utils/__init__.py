from fem_tpu_torch.utils import smallmat  # noqa: F401
