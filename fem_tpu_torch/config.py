"""Run configuration for fem_tpu_torch solves.

Mirrors the reference's two config layers (SURVEY.md §5): the .inp deck header
(`stype pdim nodal_bw` / counts / `t dt`, m_io.F90:16-18) carries the problem
definition, while this Config carries solver/runtime knobs that the reference
exposed through PETSc runtime options (main.F90:206,377).

Port of `fem_tpu/config.py`.
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
      dtype: "float64" (default; the H100 has native FP64, and fem_tpu's
        f32-inner/f64-refinement split, measured there, is slower, so the
        port does not carry it) or "float32".
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
      newton_rtol / newton_atol / newton_stol / newton_maxit: SNES-equivalent
        Newton controls of the cohesive path (PETSc defaults: rtol 1e-8
        relative to each step's first residual, atol 1e-50, stol 1e-8,
        max 50 iterations).
      formulation: cohesive residual. "reference" reproduces the shipped
        R(du) = J(du) du - F_ext - F_coh(aggregate_u + du) (m_global.F90:226);
        "standard" is the textbook incremental R(du) = K_el du - F_ext -
        F_coh(aggregate_u + du); "total" solves the true equilibrium
        K_el u = F_ext_cumulative(t) + F_coh(u) at each step end (what matches
        the Abaqus UEL cross-validation): a dense Newton under the direct
        solver, else the matrix-free Newton-Krylov, so at any size above
        `direct_threshold`, and under `n_devices` as the other forms. "auto":
        "reference" under penalty BCs (deck parity), "standard" otherwise.
      forcing: inner tolerance of the matrix-free Newton-Krylov solve: "ew"
        (Eisenstat-Walker choice 2) or "fixed" (1e-6).
      inner_krylov: "auto" (CG, with a GMRES fallback when the cohesive
        tangent turns indefinite) or "cg" (no fallback).
      quirks: reproduce two defects of the reference's cohesive element
        (see ops/cohesive.py). Default False: corrected physics.
      viscoelastic: the power-law creep correction (the live version of the
        reference's dead ReformElRHS path): per-step RHS term
        B^T D_eff dt beta(sigma) and backward-Euler ip-stress updates, from
        material columns 3-4 (viscosity, exponent), which the reference
        parses but never uses (fem_tpu `config.py:52-56`).
      checkpoint_dir / checkpoint_every / resume: write the restartable state
        every `checkpoint_every` steps into checkpoint_dir
        (utils/checkpoint.py, the npz layout fem_tpu writes) and, with
        resume, start from the newest one found there.
      profile_dir: torch.profiler trace of stepper.run, written there as a
        Chrome trace JSON (utils/timing.device_trace).
      timing: log per-phase wall-clock totals (setup / rhs / solve or
        newton / stress) after the run; on a CUDA run each phase then ends
        with a device synchronize, so it holds its device time.
      n_devices: shard the iterative solve over this many devices (the
        reference's `mpiexec -n N`), by the tier that fits the deck
        (solver/stepper.py): cell slabs of the stencil and of the MG fine
        level on a structured box; the halo block stencil on a lex-lattice
        AMG deck; the halo-gather tier, else the element-sharded operator
        (parallel/ops.py), on any other AMG deck; the element-sharded
        operator under Jacobi-PCG and under a cohesive deck's matrix-free
        Newton, in either residual form. Direct solves (the dense Newton
        forms among them) and explicit runs ignore it.
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
    newton_rtol: float = 1e-8
    newton_atol: float = 1e-50
    newton_stol: float = 1e-8
    newton_maxit: int = 50
    formulation: str = "auto"
    forcing: str = "ew"
    inner_krylov: str = "auto"
    quirks: bool = False
    viscoelastic: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    resume: bool = True
    profile_dir: Optional[str] = None
    timing: bool = False
    n_devices: Optional[int] = None

    def __post_init__(self):
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if self.dtype not in ("float64", "float32"):
            raise ValueError(f"dtype must be float64 or float32, got {self.dtype!r}")
        for name, allowed in (
                ("formulation", ("auto", "reference", "standard", "total")),
                ("forcing", ("ew", "fixed")),
                ("inner_krylov", ("auto", "cg"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")

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

    def resolve_formulation(self, bc_mode: str) -> str:
        if self.formulation != "auto":
            return self.formulation
        return "reference" if bc_mode == "penalty" else "standard"

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
