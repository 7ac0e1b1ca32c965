"""The fine operator and the preconditioner hierarchy of an assembled
elastic operator, shared by the stepper's unstructured row and the
matrix-free Newton.

The assembled K_el (scipy CSR, BCs not eliminated) picks the fine operator:
its block stencil when the connectivity is a lex lattice
(blockstencil.detect), else the fused gather/scatter operator. The
preconditioner is geometric lattice MG on a lattice above `gmg_min` DOFs,
else SA-AMG (its transfers run kernel K3). The hierarchy is built from
`A_hier`, which may differ from K_el: the Newton builds it on its
zero-opening tangent, whose interface couplings join nodes that no lattice
numbering keeps neighbours, so the lattice is detected on K_el alone.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from fem_tpu_torch.ops import blockstencil, operator
from fem_tpu_torch.solver import amg, gmg
from fem_tpu_torch.utils import timing


class FineAndHierarchy(NamedTuple):
    fine: Callable  # v -> K_el v
    dims: Optional[Tuple[int, ...]]  # the node lattice, None off one
    kind: str  # "gmg" | "amg"
    hier: object  # gmg.GMGPrecond | amg.AMGPrecond
    sizes: List[int]  # DOFs per level, fine first
    # the build's spans: "operator" (detection and the fine operator) and
    # "hierarchy"
    spans: Dict[str, timing.Span]

    def preconditioner(self, masked_fine: Callable, layout=None) -> Callable:
        mod = gmg if self.kind == "gmg" else amg
        return mod.preconditioner(self.hier, masked_fine, layout)


def build(system, A_el, A_hier=None, gmg_min: int = 0,
          coarse_max: int = 1200,
          fine: Optional[Callable] = None, bc_dofs=None,
          coords=None) -> FineAndHierarchy:
    """The fine operator of `A_el` and the hierarchy of `A_hier` (default
    `A_el`); `coarse_max` is SA-AMG's dense coarse size. A given `fine`
    (the sharded K_el v of a multi-device run) is kept as the fine
    operator; the hierarchy is chosen as without it. `bc_dofs` and `coords`
    (default: the system's) say so in A_el's numbering where it is not the
    system's (the slab order of the halo-gather tier)."""
    dtype, dev = system.dtype, system.device
    pdim, n = system.pdim, system.ndof
    A_hier = A_el if A_hier is None else A_hier
    bc_dofs = system.bc_dofs if bc_dofs is None else bc_dofs
    with timing.span("operator") as s_op:
        dims = blockstencil.detect(A_el, pdim, n // pdim)
        if fine is None and dims is not None:
            bop = blockstencil.build(A_el, pdim, dims, dtype=dtype, device=dev)
            fine = lambda v: blockstencil.matvec(bop, v)  # noqa: E731
        elif fine is None:
            fop = operator.build(system)
            fine = lambda v: operator.matvec(fop, v)  # noqa: E731
    with timing.span("hierarchy") as s_hier:
        hier = None
        if dims is not None and n > gmg_min:
            hier = gmg.build_lattice(A_hier, pdim, dims, bc_dofs=bc_dofs,
                                     dtype=dtype, device=dev)
        if hier is not None:
            kind = "gmg"
            sizes = [int(np.prod(lv.dims)) * pdim for lv in hier.levels] + [
                hier.coarse_inv.shape[0]]
        else:
            kind = "amg"
            hier = amg.build(system, bc_dofs, coarse_max=coarse_max,
                             A=A_hier, coords=coords)
            sizes = [n] + [lv.n_coarse for lv in hier.levels[:-1]]
    return FineAndHierarchy(fine=fine, dims=dims, kind=kind, hier=hier,
                            sizes=sizes,
                            spans={"operator": s_op, "hierarchy": s_hier})
