"""Run configuration for fem_tpu_torch solves.

Mirrors the reference's two config layers (SURVEY.md §5): the .inp deck header
(`stype pdim nodal_bw` / counts / `t dt`, m_io.F90:16-18) carries the problem
definition, while this Config carries solver/runtime knobs that the reference
exposed through PETSc runtime options (main.F90:206,377).

Options of `fem_tpu.config.Config` whose paths are not ported yet are still
accepted as fields, and setting them raises NotImplementedError naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    """Solver/runtime options.

    Attributes:
      device: "cuda" (default) or "cpu". CUDA requested on a machine without
        it raises; nothing falls back to the CPU.
      dtype: "float64" (default; the H100 has native FP64, so there is no
        f32-inner/f64-refinement split) or "float32".
      solver: "direct" (dense LU; the MUMPS stand-in for small n), "cg"
        (matrix-free PCG), or "auto" (direct up to `direct_threshold` DOFs).
      rtol / atol / maxiter: Krylov tolerances (reference rtol 1e-9,
        main.F90:349-351); maxiter 0 picks the path's default cap.
      bc_mode: "penalty" replicates the reference penalty method (diag<-1e30,
        m_global.F90:296,451); "eliminate" pins constrained DOFs exactly.
        "auto": penalty for direct solves, eliminate for iterative ones.
      precond: preconditioner of the unstructured iterative path: "jacobi",
        "amg" (SA-AMG, or geometric lattice MG on lattice-topology decks
        above `gmg_min` DOFs), or "auto" (amg at/above `amg_threshold` DOFs).
        Structured box decks use geometric multigrid regardless.
      gmg_min: lattice-topology decks with more DOFs than this take lattice
        GMG on the amg path; at or below it they take SA-AMG, whose coarse
        solve is then exact (the counterpart of fem_tpu's FEM_TPU_GMG_MIN).
      plane_stress: treat 2D elements as plane stress (beyond-reference).
    """

    device: str = "cuda"
    dtype: str = "float64"
    solver: str = "auto"
    rtol: float = 1e-9
    atol: float = 0.0
    maxiter: int = 0
    bc_mode: str = "auto"
    precond: str = "auto"
    amg_threshold: int = 20000
    gmg_min: int = 20000
    plane_stress: bool = False
    direct_threshold: int = 4096
    # Not ported yet: setting any of these raises (see __post_init__).
    viscoelastic: bool = False
    n_devices: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None

    def __post_init__(self):
        unported = (
            (self.viscoelastic, "viscoelastic creep", "A.8"),
            (self.n_devices is not None and self.n_devices > 1,
             "multi-device runs (n_devices > 1)", "A.9"),
            (self.checkpoint_dir is not None, "checkpoint/resume", "A.8"),
            (self.profile_dir is not None, "profiler traces", "A.8"),
        )
        for is_set, what, item in unported:
            if is_set:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP {item})"
                )
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if self.dtype not in ("float64", "float32"):
            raise ValueError(f"dtype must be float64 or float32, got {self.dtype!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def torch_device(self) -> torch.device:
        return resolve_device(self.device)

    def resolve_solver(self, ndof: int) -> str:
        if self.solver != "auto":
            return self.solver
        return "direct" if ndof <= self.direct_threshold else "cg"

    def resolve_bc_mode(self, solver: str) -> str:
        if self.bc_mode != "auto":
            return self.bc_mode
        return "penalty" if solver == "direct" else "eliminate"

    def resolve_precond(self, ndof: int) -> str:
        if self.precond != "auto":
            return self.precond
        return "amg" if ndof >= self.amg_threshold else "jacobi"


def resolve_device(device) -> torch.device:
    """torch.device for a requested device; raises when CUDA is asked for and
    absent (the port never carries on on the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev
