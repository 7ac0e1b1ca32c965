"""fem_tpu_torch — the PyTorch/CUDA port of fem_tpu for one NVIDIA H100.

A second package beside the JAX reference `fem_tpu`, with its module layout
and public names. Plain tensor code is torch; the TPU's Pallas kernels on the
ported path are hand-written CUDA for sm_90a (`ops/cuda_kernels.py`,
`csrc/`). Every device and dtype is passed explicitly: the package sets no
global default dtype, and `Config.device` defaults to "cuda" and never falls
back to the CPU.
"""

__version__ = "0.1.0"

from fem_tpu_torch.config import Config  # noqa: E402,F401
