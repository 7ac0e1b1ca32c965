"""Fused matrix-free elastic operator for unstructured meshes, in torch.

Port of `fem_tpu.ops.operator` (FusedOperator, build, block_force_un, diag)
in one schedule. K @ u is applied without element stiffness matrices: gather
the element displacements by connectivity, form the element internal force
from the stored spatial gradients and Lame parameters (two batched products
and the isotropic stress in between), and scatter-add it onto the nodes with
`index_add_`. This replaces the reference's assembled PETSc MatAIJ SpMV
(main.F90:157-171 + MatMult inside KSP). It is the fine operator of the
SA-AMG branch of the unstructured path.

On a CUDA device `index_add_` sums with atomics, so the last bits of K @ u
(and of CG iterates built on it) may differ from run to run.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fem_tpu_torch.ops import stiffness as stiff_ops
from fem_tpu_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class FusedBlock:
    """Per-element-type data, element batch first."""

    conn: torch.Tensor  # (ne, nn) int64 node ids
    dNx: torch.Tensor  # (ne, nip * pdim, nn): rows (ip, p)
    lam_s: torch.Tensor  # (ne, nip) lam * w * detJ
    mu_s: torch.Tensor  # (ne, nip) mu * w * detJ


@dataclasses.dataclass(frozen=True)
class FusedOperator:
    blocks: Tuple[FusedBlock, ...]
    ndof: int
    pdim: int


def build(system) -> FusedOperator:
    """Build from a models.system.System, on its device and in its dtype."""
    blocks = []
    for e in system.blocks.values():
        et = e["et"]
        dNx, detj = stiff_ops.grad_and_detj(et, e["ecoords"])
        ne, nip = detj.shape
        scale = detj * timing.upload(et.weights, dtype=detj.dtype,
                                      device=detj.device)[None, :]
        lam, mu = stiff_ops.lame(e["E"], e["nu"])
        blocks.append(FusedBlock(
            conn=e["conn"],
            dNx=dNx.reshape(ne, nip * et.pdim, et.nnodes).contiguous(),
            lam_s=lam[:, None] * scale,
            mu_s=mu[:, None] * scale,
        ))
    return FusedOperator(blocks=tuple(blocks), ndof=system.ndof,
                         pdim=system.pdim)


def block_force(b: FusedBlock, pdim: int, un):
    """Element internal force of one block from the gathered element
    displacements un (ne, nn, pdim); returns (ne, nn, pdim):

      g[e,i,p,q] = sum_a dNx[e,(i,p),a] un[e,a,q]
      s[e,i]     = w detJ (lam tr(g) I + mu (g + g^T))
      f[e,a,q]   = sum_(i,p) dNx[e,(i,p),a] s[e,i,p,q]
    """
    ne = un.shape[0]
    nip = b.lam_s.shape[1]
    g = torch.bmm(b.dNx, un).view(ne, nip, pdim, pdim)
    tr = g.diagonal(dim1=2, dim2=3).sum(-1)  # (ne, nip)
    sigma = (g + g.transpose(2, 3)) * b.mu_s[:, :, None, None]
    sigma.diagonal(dim1=2, dim2=3).add_((b.lam_s * tr)[:, :, None])
    return torch.bmm(b.dNx.transpose(1, 2), sigma.view(ne, nip * pdim, pdim))


def matvec(op: FusedOperator, u):
    """K @ u for flat interleaved u (ndof,)."""
    un_all = u.view(-1, op.pdim)
    out = torch.zeros_like(un_all)
    for b in op.blocks:
        f = block_force(b, op.pdim, un_all[b.conn])
        out.index_add_(0, b.conn.reshape(-1), f.reshape(-1, op.pdim))
    return out.view(-1)


def diag(op: FusedOperator):
    """Diagonal of K from the fused data:
    diag[(a,p)] = (lam+mu) sum_ip s dNx[p,a]^2 + mu sum_ip,k s dNx[k,a]^2."""
    pdim = op.pdim
    out = torch.zeros((op.ndof // pdim, pdim), dtype=op.blocks[0].dNx.dtype,
                      device=op.blocks[0].dNx.device)
    for b in op.blocks:
        ne, _, nn = b.dNx.shape
        nip = b.lam_s.shape[1]
        sq = b.dNx.view(ne, nip, pdim, nn) ** 2
        lam_h = torch.einsum("ei,eipa->eap", b.lam_s, sq)
        mu_h = torch.einsum("ei,eipa->eap", b.mu_s, sq)
        dv = lam_h + mu_h + mu_h.sum(-1, keepdim=True)
        out.index_add_(0, b.conn.reshape(-1), dv.reshape(-1, pdim))
    return out.view(-1)
