from fem_tpu_torch.io import inp, vtk  # noqa: F401
