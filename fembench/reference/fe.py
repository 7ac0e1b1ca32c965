"""Plain finite-element arithmetic of the reference: bilinear quads and
trilinear hexahedra, small-strain isotropic elasticity, assembly into one
sparse matrix, point loads, nodal stress.

The semantics are those of the deck format (defmod's `m_local.F90` and
`m_global.F90`): 2D is plane strain, stresses are in Voigt order (xx, yy, xy)
or (xx, yy, zz, xy, yz, zx) with engineering shear strains, 2 x 2 (x 2) Gauss
points, nodal stress is each element's Gauss-point stress extrapolated to its
corners and averaged over the elements that share a node, and a load acts in
a step in proportion to the overlap of the step with its time window.

Everything is written out here in plain torch, element by element in blocks,
in the dtype that the caller asks for.
"""

from __future__ import annotations

import itertools
import warnings

import numpy as np
import torch

# corner signs of the element in the natural coordinates, in the deck's node
# order (counter-clockwise; in 3D the bottom face, then the top face)
CORNERS = {
    2: np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=float),
    3: np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                 [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                dtype=float),
}
CHUNK = 1 << 16  # elements per block of the element loops


def gauss_points(pdim):
    """The 2-point Gauss rule in each direction: (nip, pdim) points, all
    weights 1."""
    g = 1.0 / np.sqrt(3.0)
    return np.array(list(itertools.product((-g, g), repeat=pdim)))


def shape_functions(pdim):
    """N (nip, nn) and dN/dxi (nip, pdim, nn) at the Gauss points."""
    pts, corners = gauss_points(pdim), CORNERS[pdim]
    # (nip, nn, pdim): 1 + xi_d * corner_d
    f = 1.0 + pts[:, None, :] * corners[None, :, :]
    N = np.prod(f, axis=2) / 2.0 ** pdim
    dN = np.empty((pts.shape[0], pdim, corners.shape[0]))
    for d in range(pdim):
        others = np.prod(np.delete(f, d, axis=2), axis=2)
        dN[:, d, :] = corners[None, :, d] * others / 2.0 ** pdim
    return N, dN


def elasticity_matrix(E, nu, pdim):
    """Isotropic D (cpdim, cpdim) in Voigt order with engineering shear; 2D
    is plane strain."""
    c = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    g = c * (1.0 - 2.0 * nu) / 2.0
    if pdim == 2:
        return np.array([[c * (1 - nu), c * nu, 0.0],
                         [c * nu, c * (1 - nu), 0.0],
                         [0.0, 0.0, g]])
    D = np.zeros((6, 6))
    D[:3, :3] = c * nu
    D[[0, 1, 2], [0, 1, 2]] = c * (1 - nu)
    D[[3, 4, 5], [3, 4, 5]] = g
    return D


def strain_matrix(dNx):
    """B (..., cpdim, nn * pdim) from the spatial gradients dNx
    (..., pdim, nn); dofs interleaved per node (n0x, n0y[, n0z], n1x, ...)."""
    pdim, nn = dNx.shape[-2], dNx.shape[-1]
    cp = 3 if pdim == 2 else 6
    B = dNx.new_zeros(dNx.shape[:-2] + (cp, nn, pdim))
    for d in range(pdim):
        B[..., d, :, d] = dNx[..., d, :]
    # engineering shear rows: (xy) in 2D; (xy, yz, zx) in 3D
    pairs = [(0, 1)] if pdim == 2 else [(0, 1), (1, 2), (2, 0)]
    for row, (a, b) in enumerate(pairs, start=pdim):
        B[..., row, :, a] = dNx[..., b, :]
        B[..., row, :, b] = dNx[..., a, :]
    return B.reshape(dNx.shape[:-2] + (cp, nn * pdim))


class Mesh:
    """One block of quads or hexes, with one isotropic material, on a torch
    device: coordinates, connectivity and the per-element geometry that the
    stiffness, the stress and the creep terms read."""

    def __init__(self, coords, conn, E, nu, *, dtype, device):
        self.dtype, self.device = dtype, torch.device(device)
        self.coords = np.asarray(coords, dtype=float)
        self.nnds, self.pdim = self.coords.shape
        self.ndof = self.nnds * self.pdim
        self.cp = 3 if self.pdim == 2 else 6
        self.conn = torch.as_tensor(np.asarray(conn, dtype=np.int64),
                                    device=self.device)
        self.ne, self.nn = self.conn.shape
        N, dN = shape_functions(self.pdim)
        self.nip = N.shape[0]
        self._dN = self._t(dN)
        # nodal extrapolation: corner values from Gauss values, inverse of N
        self.extrap = self._t(np.linalg.inv(N))
        self.D = self._t(elasticity_matrix(E, nu, self.pdim))
        offs = torch.arange(self.pdim, device=self.device)
        self.edofs = (self.conn[:, :, None] * self.pdim + offs).reshape(
            self.ne, self.nn * self.pdim)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def chunks(self):
        for s in range(0, self.ne, CHUNK):
            yield slice(s, min(s + CHUNK, self.ne))

    def geometry(self, sl):
        """B (ne, nip, cp, nn*pdim) and w * det J (ne, nip) of a block of
        elements."""
        X = self._t(self.coords[self.conn[sl].cpu().numpy()])
        J = torch.einsum("ipa,ead->eipd", self._dN, X)
        dNx = torch.linalg.solve(J, self._dN.expand(J.shape[0], -1, -1, -1))
        return strain_matrix(dNx), torch.linalg.det(J)

    def stiffness(self):
        """The assembled K as a sparse CSR tensor (no boundary conditions)."""
        nd = self.nn * self.pdim
        rows, cols, vals = [], [], []
        for sl in self.chunks():
            B, wdet = self.geometry(sl)
            ke = torch.einsum("eica,cd,eidb,ei->eab", B, self.D, B, wdet)
            ed = self.edofs[sl]
            rows.append(ed[:, :, None].expand(-1, nd, nd).reshape(-1))
            cols.append(ed[:, None, :].expand(-1, nd, nd).reshape(-1))
            vals.append(ke.reshape(-1))
        return csr_from_triplets(torch.cat(rows), torch.cat(cols),
                                 torch.cat(vals), self.ndof)

    def ip_strain(self, u, sl):
        """Strain at the Gauss points (ne, nip, cp) of a block of elements."""
        B, _ = self.geometry(sl)
        return torch.einsum("eica,ea->eic", B, u[self.edofs[sl]])

    def nodal_average(self, sigma_ip):
        """Gauss-point values (ne, nip, cp) to corner values, summed per
        node and divided by the number of elements at the node."""
        sums = torch.zeros((self.nnds, self.cp), dtype=self.dtype,
                           device=self.device)
        at_nodes = torch.einsum("ai,eic->eac", self.extrap, sigma_ip)
        flat = self.conn.reshape(-1)
        sums.index_add_(0, flat, at_nodes.reshape(-1, self.cp))
        count = torch.bincount(flat, minlength=self.nnds).to(self.dtype)
        return sums / count.clamp(min=1.0)[:, None]

    def stress(self, u):
        """Nodal stress (nnds, cp) of the displacement u."""
        sig = torch.cat([torch.einsum("cd,eid->eic", self.D,
                                      self.ip_strain(u, sl))
                         for sl in self.chunks()])
        return self.nodal_average(sig)


def csr_from_triplets(rows, cols, vals, n):
    """Sum duplicate (row, col) entries and return an n x n CSR tensor."""
    key = rows * n + cols
    uniq, inv = torch.unique(key, return_inverse=True)
    data = torch.zeros(uniq.shape[0], dtype=vals.dtype, device=vals.device)
    data.index_add_(0, inv, vals)
    r = uniq // n
    crow = torch.zeros(n + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    with warnings.catch_warnings():  # torch marks sparse CSR as beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, uniq % n, data, (n, n),
                                       check_invariants=False)


def window_fraction(t_init, t_end, t1, t2):
    """Share of a load with time window [t1, t2] that the step
    [t_init, t_end] applies: their overlap over the window's length, 0 for
    a window of no length or one that the step does not meet."""
    t1, t2 = np.asarray(t1, float), np.asarray(t2, float)
    width = t2 - t1
    meet = (t_end >= t1) & (t_init <= t2) & (width > 0)
    overlap = np.minimum(t2, t_end) - np.maximum(t1, t_init)
    return np.where(meet, overlap / np.where(width > 0, width, 1.0), 0.0)


def load_vector(ndof, force_dofs, force_vec, t1, t2, t_init, t_end):
    """Nodal point loads of one step as a numpy vector of ndof."""
    F = np.zeros(ndof)
    frac = window_fraction(t_init, t_end, t1, t2)
    np.add.at(F, np.asarray(force_dofs).reshape(-1),
              (np.asarray(force_vec) * frac[:, None]).reshape(-1))
    return F
