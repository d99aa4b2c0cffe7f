"""The non-matching coupling operator C (the heart of the fictitious-domain
method).

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.coupling``:

    C[j, i] = ∫_Γ  φ_i^bg  ψ_j^imm  dΓ

Setup builds a quad-point table: every immersed quadrature point is located
in its background cell by index arithmetic and both bases are tabulated there
(on the host, by the C++ routines of :mod:`..native`, or their NumPy forms
without a C++ compiler).  ``C u`` is a gather and a row sum; ``Cᵀ λ`` is an
``index_add_``; both also take (n, k) column blocks (the Stokes vector
coupling applies the scalar table to every component at once).  The AL
term γ·CᵀW⁻¹C applies matrix-free (:meth:`Coupling.al_term`); the particle
form γ·Σ_q φφᵀ JxW has a gather
form (:meth:`Coupling.particle_mass_term`) and two lattice forms: the
9-point patch (:meth:`Coupling.patch_w9`, :meth:`Coupling.patch_al_lattice`,
:meth:`Coupling.patch_stencil_al`) when the band is interior to the lattice,
and the compact dense block (:meth:`Coupling.compact_al`) otherwise, which
also holds the explicit form γ·Cᵀdiag(w)C.  A rank of the sharded solve
keeps its rows of the table (:meth:`Coupling.row_block`) and of the
compact block (:meth:`Coupling.compact_al_rows`, :class:`CompactRows`).
Each ``C u`` and ``Cᵀ λ`` is a ``coupling.mv`` / ``coupling.rmv`` span
(:mod:`..tracer`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core.quadrature import gauss
from ..tracer import span
from .linop import LinOp

__all__ = ["Coupling", "CompactRows", "VectorCoupling", "build_coupling",
           "accumulate_al"]


def accumulate_al(idx, phi, w, m):
    """Dense compact-AL accumulation ``A[idx_a, idx_b] += phi_a phi_b w``
    (the NumPy form of :func:`..native.accumulate_al`)."""
    A = np.zeros((m, m))
    contrib = np.einsum("qa,qb,q->qab", phi, phi, w)
    np.add.at(A, (idx[:, :, None], idx[:, None, :]), contrib)
    return A


class Coupling:
    """Quad-point form of C : V_bg -> V_imm (shape (n_imm, n_bg)).

    The table is kept twice: as float64 NumPy arrays for setup-time work
    (``host``) and as tensors on ``device`` for the applies.  ``points``
    (optional, host) are the physical quadrature points, (nq, spacedim)."""

    def __init__(self, bg_dofs, bg_phi, imm_dofs, imm_psi, jxw, shape, *,
                 device, dtype, points=None):
        self.host = dict(bg_dofs=np.asarray(bg_dofs),
                         bg_phi=np.asarray(bg_phi, dtype=np.float64),
                         imm_dofs=np.asarray(imm_dofs),
                         imm_psi=np.asarray(imm_psi, dtype=np.float64),
                         jxw=np.asarray(jxw, dtype=np.float64))
        self.shape = tuple(int(s) for s in shape)
        self.points = None if points is None else np.asarray(points)
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

    def to(self, device, dtype) -> "Coupling":
        """The same table on ``device`` in ``dtype`` (from the float64 host
        copy)."""
        h = self.host
        return Coupling(h["bg_dofs"], h["bg_phi"], h["imm_dofs"],
                        h["imm_psi"], h["jxw"], self.shape, device=device,
                        dtype=dtype, points=self.points)

    def row_block(self, lo: int, hi: int, nx: int) -> "Coupling":
        """This rank's part of a lattice background's table for the row
        block ``[lo, hi)`` of an ``nx``-column lattice: every quadrature
        point, its dofs shifted to the block's flat numbering, and a zero
        basis value on every dof outside the block (that entry adds
        nothing).  Its ``interp_bg`` and ``mv`` are the block's share of
        ``u`` at the quadrature points and of ``C u`` (the ranks' shares
        sum to them: an all-reduce), its ``rmv`` the block's rows of
        ``Cᵀ λ``; shape ``(n_imm, (hi - lo) * nx)``."""
        h = self.host
        first, last = lo * nx, hi * nx
        dofs = h["bg_dofs"].astype(np.int64)
        own = (dofs >= first) & (dofs < last)
        return Coupling(np.where(own, dofs - first, 0),
                        np.where(own, h["bg_phi"], 0.0), h["imm_dofs"],
                        h["imm_psi"], h["jxw"], (self.shape[0], last - first),
                        device=self.device, dtype=self.dtype,
                        points=self.points)

    def astype(self, dtype) -> "Coupling":
        """This coupling in ``dtype`` on its device (itself if it is
        already)."""
        return self if dtype == self.dtype else self.to(self.device, dtype)

    def interp_bg(self, u):
        """u_h^bg at the quadrature points: (nq,) for u of shape (n_bg,),
        (nq, k) for a column block (n_bg, k)."""
        if u.dim() == 2:
            return (u[self.bg_dofs] * self.bg_phi[:, :, None]).sum(dim=1)
        return (u[self.bg_dofs] * self.bg_phi).sum(dim=1)

    def mv(self, u):
        """C @ u : background -> immersed; u is (n_bg,) or a column block
        (n_bg, k)."""
        with span("coupling.mv"):
            if u.dim() == 2:
                vals = self.interp_bg(u) * self.jxw[:, None]
                out = torch.zeros((self.shape[0], u.shape[1]),
                                  dtype=u.dtype, device=u.device)
                return out.index_add_(
                    0, self.imm_dofs.reshape(-1),
                    (self.imm_psi[:, :, None] * vals[:, None, :]).reshape(
                        -1, u.shape[1]))
            vals = (u[self.bg_dofs] * self.bg_phi).sum(dim=1) * self.jxw
            out = torch.zeros(self.shape[0], dtype=u.dtype, device=u.device)
            return out.index_add_(0, self.imm_dofs.reshape(-1),
                                  (self.imm_psi * vals[:, None]).reshape(-1))

    def rmv(self, lam):
        """Cᵀ @ λ : immersed -> background; λ is (n_imm,) or a column block
        (n_imm, k)."""
        with span("coupling.rmv"):
            if lam.dim() == 2:
                vals = ((lam[self.imm_dofs]
                         * self.imm_psi[:, :, None]).sum(dim=1)
                        * self.jxw[:, None])
                out = torch.zeros((self.shape[1], lam.shape[1]),
                                  dtype=lam.dtype, device=lam.device)
                return out.index_add_(
                    0, self.bg_dofs.reshape(-1),
                    (self.bg_phi[:, :, None] * vals[:, None, :]).reshape(
                        -1, lam.shape[1]))
            vals = (lam[self.imm_dofs] * self.imm_psi).sum(dim=1) * self.jxw
            out = torch.zeros(self.shape[1], dtype=lam.dtype,
                              device=lam.device)
            return out.index_add_(0, self.bg_dofs.reshape(-1),
                                  (self.bg_phi * vals[:, None]).reshape(-1))

    def as_linop(self) -> LinOp:
        return LinOp(self.mv, self.shape, self.rmv, name="C")

    def al_term(self, inv_w, gamma: float) -> LinOp:
        """γ CᵀW⁻¹C as a matrix-free LinOp (the AL augmentation, reference
        'Use operator version': immersed_laplace.cc:653-705)."""
        n = self.shape[1]

        def mv(u):
            return gamma * self.rmv(inv_w(self.mv(u)))

        return LinOp(mv, (n, n), mv, name="AL")

    def particle_mass_term(self, gamma: float) -> LinOp:
        """γ·∫_Γ φ_i φ_j: the background mass matrix on Γ from the
        quad-point table (the reference's particle AL loop,
        immersed_laplace.cc:653-705) as a matrix-free operator."""
        n = self.shape[1]

        def mv(u):
            vals = (u[self.bg_dofs] * self.bg_phi).sum(dim=1) * self.jxw
            out = torch.zeros_like(u)
            return gamma * out.index_add_(
                0, self.bg_dofs.reshape(-1),
                (self.bg_phi * vals[:, None]).reshape(-1))

        return LinOp(mv, (n, n), mv, name="particleAL")

    def particle_mass_diag(self, gamma: float) -> np.ndarray:
        """Diagonal of :meth:`particle_mass_term` (float64 NumPy, flat)."""
        h = self.host
        return gamma * np.bincount(
            h["bg_dofs"].reshape(-1),
            weights=(h["bg_phi"] ** 2 * h["jxw"][:, None]).reshape(-1),
            minlength=self.shape[1])

    def al_term_diag(self, w_diag, gamma: float) -> np.ndarray:
        """Diagonal of γ·Cᵀdiag(w)C from the deduplicated COO of C (host
        setup, float64 NumPy; feeds the smoothers of the augmented
        block)."""
        rows, cols, vals = self.to_coo()
        ncols = self.shape[1]
        key = rows.astype(np.int64) * ncols + cols.astype(np.int64)
        order = np.argsort(key, kind="stable")
        key_s, vals_s = key[order], vals[order]
        starts = np.concatenate([[0], np.flatnonzero(np.diff(key_s)) + 1])
        v = np.add.reduceat(vals_s, starts)
        r = (key_s[starts] // ncols).astype(np.int64)
        c = (key_s[starts] % ncols).astype(np.int64)
        w = np.asarray(w_diag, dtype=np.float64)
        d = np.zeros(ncols)
        np.add.at(d, c, w[r] * v ** 2)
        return gamma * d

    def sum(self) -> float:
        """Sum of all entries of C, |Γ| when both spaces hold the constants
        (DEBUG check, nitsche_bcs.cc:467-490)."""
        h = self.host
        return float(np.sum(h["bg_phi"].sum(axis=1)
                            * h["imm_psi"].sum(axis=1) * h["jxw"]))

    def to_coo(self):
        """Explicit COO of C (duplicates not summed): rows (immersed), cols
        (background), vals; float64 NumPy."""
        h = self.host
        nb = h["bg_phi"].shape[1]
        ni = h["imm_psi"].shape[1]
        rows = np.repeat(h["imm_dofs"], nb, axis=1).reshape(-1)
        cols = np.tile(h["bg_dofs"], (1, ni)).reshape(-1)
        vals = (h["imm_psi"][:, :, None] * h["bg_phi"][:, None, :]
                * h["jxw"][:, None, None]).reshape(-1)
        return rows, cols, vals

    def to_dense(self) -> np.ndarray:
        rows, cols, vals = self.to_coo()
        out = np.zeros(self.shape)
        np.add.at(out, (rows, cols), vals)
        return out

    def compact_al(self, gamma: float, w_diag=None, dtype=None):
        """Compact dense form of an AL matrix over the set of background
        dofs the band touches: the particle form γ·Σ_q JxW φφᵀ with
        ``w_diag=None`` (immersed_laplace.cc:653-705), else the explicit
        form γ·Cᵀdiag(w)C (``coupling.py:120-170`` of the reference).  The
        block is formed once, in float64 (the explicit one as the SpGEMM of
        :func:`.sparse.spgemm_ctwc` scattered into the dense block on the
        coupling's device), and held in ``dtype`` (default: the
        coupling's), the dtype of the level that applies it.  Returns
        ``(LinOp, diag)`` with ``diag`` the flat assembled diagonal (float64
        NumPy); the LinOp's ``rows`` is the block's row count."""
        dofs = self.host["bg_dofs"]
        uniq, inv = np.unique(dofs.reshape(-1), return_inverse=True)
        m = len(uniq)
        if w_diag is None:
            A = torch.as_tensor(native.accumulate_al(
                inv.reshape(dofs.shape), self.host["bg_phi"],
                self.host["jxw"], m), device=self.device)
        else:
            from .sparse import COO, spgemm_ctwc

            ctwc = spgemm_ctwc(COO.from_coupling(self),
                               np.asarray(w_diag, dtype=np.float64))
            A = torch.zeros((m, m), dtype=torch.float64, device=self.device)
            A[torch.as_tensor(np.searchsorted(uniq, ctwc.rows),
                              device=self.device),
              torch.as_tensor(np.searchsorted(uniq, ctwc.cols),
                              device=self.device)] = torch.as_tensor(
                ctwc.vals, device=self.device)
        Aj = (gamma * A).to(self.dtype).to(dtype or self.dtype)
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
        diag[uniq] = gamma * torch.diagonal(A).cpu().numpy()
        lin = LinOp(mv, (n, n), mv, name="AL_compact")
        lin.rows = m
        return lin, diag

    def compact_al_rows(self, gamma: float, first: int, last: int,
                        w_diag=None, dtype=None) -> "CompactRows":
        """The rows of :meth:`compact_al`'s block that belong to the
        background dofs ``[first, last)`` (a rank's rows of the sharded
        solve): ``m_own x m`` entries, formed in float64 from the block's
        COO entries in those rows (the whole ``m x m`` never is), held in
        ``dtype`` (default: the coupling's).  See :class:`CompactRows`."""
        dofs = self.host["bg_dofs"]
        uniq = np.unique(dofs.reshape(-1))
        if w_diag is None:
            phi, jxw = self.host["bg_phi"], self.host["jxw"]
            rows = np.repeat(dofs, dofs.shape[1], axis=1).reshape(-1)
            cols = np.tile(dofs, (1, dofs.shape[1])).reshape(-1)
            vals = (phi[:, :, None] * phi[:, None, :]
                    * jxw[:, None, None]).reshape(-1)
        else:
            from .sparse import COO, spgemm_ctwc

            ctwc = spgemm_ctwc(COO.from_coupling(self),
                               np.asarray(w_diag, dtype=np.float64))
            rows, cols, vals = ctwc.rows, ctwc.cols, ctwc.vals
        rows, cols = rows.astype(np.int64), cols.astype(np.int64)
        p0, p1 = np.searchsorted(uniq, (first, last))
        own = (rows >= first) & (rows < last)
        A = np.zeros((p1 - p0, len(uniq)))
        np.add.at(A, (np.searchsorted(uniq, rows[own]) - p0,
                      np.searchsorted(uniq, cols[own])), vals[own])
        diag = np.zeros(self.shape[1])
        on = rows == cols
        np.add.at(diag, rows[on], gamma * vals[on])
        return CompactRows(
            torch.as_tensor(uniq, dtype=torch.int64, device=self.device),
            int(p0), int(p1), first, last,
            torch.as_tensor(gamma * A, dtype=self.dtype,
                            device=self.device).to(dtype or self.dtype),
            diag)

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

    def patch_stencil_al(self, space, gamma: float):
        """Particle-form AL term γ·Σ_q JxW φφᵀ as a variable-coefficient
        9-point stencil on the Γ-band's bounding patch (the 9 planes of
        :meth:`patch_w9`), applied to flat vectors: ``(LinOp, diag)`` with
        the flat assembled diagonal (float64 NumPy), or None when the space
        is not a Q1 lattice or the band touches its boundary."""
        al = self.patch_al_lattice(space, gamma)
        if al is None:
            return None
        mv2, diag = al
        lat = tuple(reversed(space.n_points_1d))
        n = self.shape[1]

        def mv(u):
            return mv2(u.reshape(lat)).reshape(-1)

        return LinOp(mv, (n, n), mv, name="AL_stencil"), diag

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
        dg = np.zeros((ny, nx))
        dg[r0:r0 + pr, c0:c0 + pc] = w9[1, 1]
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

        return mv2, dg.reshape(-1)


class CompactRows:
    """A rank's rows of a compact AL block (:meth:`Coupling.compact_al_rows`):
    ``uniq`` are the block's background dofs (all ``m`` of them, sorted),
    ``uniq[p0:p1]`` those in the rank's dofs ``[first, last)``, ``A`` their
    rows (``m_own x m``), ``diag`` the whole flat assembled diagonal
    (float64 NumPy) and ``rows`` = m.  :meth:`share` writes the rank's band
    entries of a vector of its dofs into a zero m-vector; the ranks' shares
    sum (an all-reduce, exact: every entry has one contributor) to the
    band's values, which :meth:`apply` multiplies by the rank's rows and
    scatters into its dofs.  With the whole vector at hand (the element
    form gathers it), ``apply(x[uniq])`` needs no reduction."""

    def __init__(self, uniq, p0, p1, first, last, A, diag):
        self.uniq, self.p0, self.p1 = uniq, p0, p1
        self.first, self.last = first, last
        self.local = uniq[p0:p1] - first
        self.A = A
        self.diag = diag
        self.rows = int(uniq.numel())

    def share(self, x_own: torch.Tensor) -> torch.Tensor:
        band = torch.zeros(self.rows, dtype=x_own.dtype, device=x_own.device)
        band[self.p0:self.p1] = x_own[self.local]
        return band

    def apply(self, band: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(self.last - self.first, dtype=band.dtype,
                          device=band.device)
        out[self.local] = self.A.to(band.dtype) @ band
        return out


class VectorCoupling:
    """Componentwise vector coupling over a scalar quad-point table:
    velocity (n_comp·n_bg, component-major) <-> vector multiplier
    (n_comp·n_imm).  C[(j,c),(i,c)] = ∫_Γ φ_i ψ_j, the same scalar kernel in
    every component (stokes_immersed_boundary.cc:660,782)."""

    def __init__(self, scalar: Coupling, n_comp: int):
        self.scalar = scalar
        self.n_comp = n_comp
        self.shape = (scalar.shape[0] * n_comp, scalar.shape[1] * n_comp)

    def mv(self, u_flat):
        u = u_flat.reshape(self.n_comp, self.scalar.shape[1])
        return self.scalar.mv(u.T).T.reshape(-1)

    def rmv(self, lam_flat):
        lam = lam_flat.reshape(self.n_comp, self.scalar.shape[0])
        return self.scalar.rmv(lam.T).T.reshape(-1)

    def as_linop(self) -> LinOp:
        return LinOp(self.mv, self.shape, self.rmv, name="C_vec")

    def al_term_diag(self, w_diag_scalar, gamma) -> np.ndarray:
        """Diagonal of γ·Cᵀdiag(w)C in every component (float64 NumPy)."""
        return np.tile(self.scalar.al_term_diag(w_diag_scalar, gamma),
                       self.n_comp)


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
    in every reference prm) by point location on the uniform grid and
    tabulation there (the C++ routines of :mod:`..native` when the library
    is available, NumPy otherwise: the same table), or through the folded
    tabulation of a locally refined background (``tabulate_at``: the
    hanging-node constraints are in the table)."""
    mesh = imm_space.mesh
    rule = gauss(mesh.dim, order)
    X, _, jxw = mesh.quad_geometry(rule)
    nc, nq_pc, sd = X.shape
    flat_pts = X.reshape(-1, sd)

    if hasattr(bg_space, "tabulate_at"):
        bg_dofs, bg_phi = bg_space.tabulate_at(flat_pts)
    else:
        grid = bg_space.grid
        cells, refs = native.locate_points(flat_pts, np.asarray(grid.origin),
                                           grid.h, np.asarray(grid.ncells))
        if hasattr(bg_space.fe, "nodes_1d"):
            bg_phi = native.tabulate(refs, bg_space.fe.nodes_1d, grid.dim)
        else:                                   # a DGP element
            bg_phi = bg_space.fe.tabulate(refs)
        bg_dofs = _cell_dofs_of(bg_space, cells)

    psi = imm_space.fe.tabulate(rule.points)
    imm_psi = np.broadcast_to(psi[None], (nc, nq_pc, psi.shape[1])).reshape(
        -1, psi.shape[1])
    imm_dofs = np.repeat(imm_space.cell_dofs[:, None, :], nq_pc,
                         axis=1).reshape(-1, imm_space.cell_dofs.shape[1])
    return Coupling(bg_dofs, bg_phi, imm_dofs, imm_psi, jxw.reshape(-1),
                    (imm_space.n_dofs, bg_space.n_dofs), device=device,
                    dtype=dtype, points=flat_pts)
