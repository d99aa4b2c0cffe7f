"""The non-matching coupling operator C (the heart of the fictitious-domain
method).

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.coupling``:

    C[j, i] = ∫_Γ  φ_i^bg  ψ_j^imm  dΓ

Setup builds a quad-point table: every immersed quadrature point is located
in its background cell by index arithmetic and both bases are tabulated there
(NumPy, host).  ``C u`` is a gather and a row sum; ``Cᵀ λ`` is an
``index_add_``.  The Γ-band AL term of the particle form has two lattice
forms: the 9-point patch (:meth:`Coupling.patch_w9`,
:meth:`Coupling.patch_al_lattice`) when the band is interior to the lattice,
and the compact dense block (:meth:`Coupling.compact_al`) otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quadrature import gauss
from .linop import LinOp

__all__ = ["Coupling", "build_coupling", "accumulate_al"]


def accumulate_al(idx, phi, w, m):
    """Dense compact-AL accumulation ``A[idx_a, idx_b] += phi_a phi_b w``
    (the NumPy form of the reference package's native ``accumulate_al``)."""
    A = np.zeros((m, m))
    contrib = np.einsum("qa,qb,q->qab", phi, phi, w)
    np.add.at(A, (idx[:, :, None], idx[:, None, :]), contrib)
    return A


class Coupling:
    """Quad-point form of C : V_bg -> V_imm (shape (n_imm, n_bg)).

    The table is kept twice: as float64 NumPy arrays for setup-time work
    (``host``) and as tensors on ``device`` for the applies."""

    def __init__(self, bg_dofs, bg_phi, imm_dofs, imm_psi, jxw, shape, *,
                 device, dtype):
        self.host = dict(bg_dofs=np.asarray(bg_dofs),
                         bg_phi=np.asarray(bg_phi, dtype=np.float64),
                         imm_dofs=np.asarray(imm_dofs),
                         imm_psi=np.asarray(imm_psi, dtype=np.float64),
                         jxw=np.asarray(jxw, dtype=np.float64))
        self.shape = tuple(int(s) for s in shape)
        self.device = torch.device(device)
        self.dtype = dtype

        def ten(a, dt):
            return torch.as_tensor(np.array(a), dtype=dt,
                                   device=self.device)

        h = self.host
        self.bg_dofs = ten(h["bg_dofs"], torch.int64)
        self.bg_phi = ten(h["bg_phi"], dtype)
        self.imm_dofs = ten(h["imm_dofs"], torch.int64)
        self.imm_psi = ten(h["imm_psi"], dtype)
        self.jxw = ten(h["jxw"], dtype)

    def mv(self, u):
        """C @ u : background -> immersed."""
        vals = (u[self.bg_dofs] * self.bg_phi).sum(dim=1) * self.jxw
        out = torch.zeros(self.shape[0], dtype=u.dtype, device=u.device)
        return out.index_add_(0, self.imm_dofs.reshape(-1),
                              (self.imm_psi * vals[:, None]).reshape(-1))

    def rmv(self, lam):
        """Cᵀ @ λ : immersed -> background."""
        vals = (lam[self.imm_dofs] * self.imm_psi).sum(dim=1) * self.jxw
        out = torch.zeros(self.shape[1], dtype=lam.dtype, device=lam.device)
        return out.index_add_(0, self.bg_dofs.reshape(-1),
                              (self.bg_phi * vals[:, None]).reshape(-1))

    def as_linop(self) -> LinOp:
        return LinOp(self.mv, self.shape, self.rmv, name="C")

    def compact_al(self, gamma: float, dtype=None):
        """Compact dense form of the particle AL matrix γ·Σ_q JxW φφᵀ over
        the set of background dofs the band touches.  Returns
        ``(LinOp, diag)`` with ``diag`` the flat assembled diagonal (float64
        NumPy).  The block is held in ``dtype`` (default: the coupling's),
        the dtype of the level that applies it."""
        dofs = self.host["bg_dofs"]
        uniq, inv = np.unique(dofs.reshape(-1), return_inverse=True)
        inv = inv.reshape(dofs.shape)
        A = accumulate_al(inv, self.host["bg_phi"], self.host["jxw"],
                          len(uniq))
        Aj = torch.as_tensor(gamma * A, dtype=self.dtype,
                             device=self.device).to(dtype or self.dtype)
        uniqj = torch.as_tensor(uniq, dtype=torch.int64, device=self.device)
        n = self.shape[1]

        def mv(u):
            # the block in the input's dtype, as the reference casts it
            # (coupling.py:159): a bfloat16 level stays bfloat16; ``to`` is
            # a no-op on a level built in the input's dtype
            out = torch.zeros_like(u)
            out[uniqj] = Aj.to(u.dtype) @ u[uniqj]
            return out

        diag = np.zeros(n)
        diag[uniq] = gamma * np.diagonal(A)
        return LinOp(mv, (n, n), mv, name="AL_compact"), diag

    def patch_w9(self, space, gamma: float, free=None):
        """Raw Γ-band 9-point patch weights ``((r0, c0, pr, pc), w9)``, float64
        NumPy: ``w9[a, b, i, j]`` multiplies ``x[r0+i+a-1, c0+j+b-1]`` at
        output lattice point ``(r0+i, c0+j)``.  None when the space is not a
        Q1 lattice or the band touches the lattice boundary."""
        if not (hasattr(space, "n_points_1d") and space.fe.degree == 1
                and space.continuous):
            return None
        npts = space.n_points_1d
        nx, ny = npts[0], npts[1]
        dofs = self.host["bg_dofs"]
        rows = dofs // nx
        cols = dofs % nx
        r0, r1 = int(rows.min()), int(rows.max())
        c0, c1 = int(cols.min()), int(cols.max())
        if r0 < 1 or c0 < 1 or r1 > ny - 2 or c1 > nx - 2:
            return None
        pr, pc = r1 - r0 + 1, c1 - c0 + 1
        phi = self.host["bg_phi"]
        if free is not None:
            phi = phi * np.asarray(free, dtype=phi.dtype)[dofs]
        jxw = self.host["jxw"]
        locmat = jxw[:, None, None] * phi[:, :, None] * phi[:, None, :]
        w9 = np.zeros((3, 3, pr, pc))
        for i in range(dofs.shape[1]):
            for j in range(dofs.shape[1]):
                dr = rows[:, j] - rows[:, i] + 1
                dc = cols[:, j] - cols[:, i] + 1
                np.add.at(w9, (dr, dc, rows[:, i] - r0, cols[:, i] - c0),
                          locmat[:, i, j])
        return (r0, c0, pr, pc), gamma * w9

    def patch_al_lattice(self, space, gamma: float, free=None, dtype=None):
        """Lattice-resident particle AL apply ``mv2(x2d) -> (ny, nx)`` from
        the 9-point patch, and the flat assembled diagonal (float64 NumPy).
        ``free`` bakes
        Dirichlet input masking into the weights.  None when the band is not
        interior to the lattice.  The weights take the input's dtype before
        the products, as in the reference (``coupling.py:339-350``), so a
        bfloat16 level stays bfloat16; they are cast once, here, to ``dtype``
        (default: the coupling's), the dtype of the level that applies
        them."""
        pw = self.patch_w9(space, gamma, free=free)
        if pw is None:
            return None
        (r0, c0, pr, pc), w9 = pw
        nx, ny = space.n_points_1d
        w9t = torch.as_tensor(w9, dtype=self.dtype,
                              device=self.device).to(dtype or self.dtype)

        def mv2(x2d):
            up = x2d[r0 - 1:r0 + pr + 1, c0 - 1:c0 + pc + 1]
            w = w9t.to(x2d.dtype)   # a no-op in the dtype it was built in
            acc = None
            for a in range(3):
                for b in range(3):
                    term = w[a, b] * up[a:a + pr, b:b + pc]
                    acc = term if acc is None else acc + term
            out = torch.zeros((ny, nx), dtype=x2d.dtype, device=x2d.device)
            out[r0:r0 + pr, c0:c0 + pc] = acc
            return out

        dg = np.zeros((ny, nx))
        dg[r0:r0 + pr, c0:c0 + pc] = w9[1, 1]
        return mv2, dg.reshape(-1)


def _cell_dofs_of(space, cells):
    """Global dof indices (n, nloc) of the given background cells — the rows
    ``space.cell_dofs[cells]`` without building the whole cell table."""
    grid = space.grid
    k = space.fe.degree
    npts = space.n_points_1d
    strides = np.cumprod([1] + list(npts[:-1]))
    idx = np.asarray(cells, dtype=np.int64)
    mi = np.empty((idx.shape[0], grid.dim), dtype=np.int64)
    for d in range(grid.dim):
        mi[:, d] = idx % grid.ncells[d]
        idx = idx // grid.ncells[d]
    per_dim = mi[:, None, :] * k + space.fe.node_multi_indices[None, :, :]
    return (per_dim @ strides).astype(np.int32)


def build_coupling(bg_space, imm_space, order: int = 3, *,
                   device="cuda", dtype=torch.float64) -> Coupling:
    """Assemble the quad-point coupling table ('Coupling quadrature order'
    in every reference prm) by NumPy point location on the uniform grid."""
    mesh = imm_space.mesh
    rule = gauss(mesh.dim, order)
    X, _, jxw = mesh.quad_geometry(rule)
    nc, nq_pc, sd = X.shape
    flat_pts = X.reshape(-1, sd)

    cells, refs = bg_space.grid.locate(flat_pts)
    bg_phi = bg_space.fe.tabulate(refs)
    bg_dofs = _cell_dofs_of(bg_space, cells)

    psi = imm_space.fe.tabulate(rule.points)
    imm_psi = np.broadcast_to(psi[None], (nc, nq_pc, psi.shape[1])).reshape(
        -1, psi.shape[1])
    imm_dofs = np.repeat(imm_space.cell_dofs[:, None, :], nq_pc,
                         axis=1).reshape(-1, imm_space.cell_dofs.shape[1])
    return Coupling(bg_dofs, bg_phi, imm_dofs, imm_psi, jxw.reshape(-1),
                    (imm_space.n_dofs, bg_space.n_dofs), device=device,
                    dtype=dtype)
