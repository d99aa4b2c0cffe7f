"""FEM assembly.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.assembly``:
the background mass and stiffness matrices of a uniform grid (one shared
reference local matrix), the load vector (the Q1 lattice form, and the
element form of any degree, continuous or not, for scalar and vector
functions), the immersed mass and stiffness matrices and load vector
(scalar or vector), the reference local matrices of the vector blocks
(the Stokes velocity block in its grad-div and symmetric-gradient forms,
the elasticity block and the divergence block), nodal interpolation and
the L2 and H1 errors.  On a locally refined space (``core.adaptive``) the
matrices are element form with the hanging-node fold applied
(:func:`adaptive_matrix`: one shared local matrix per level for the cells
without a hanging node, per-cell folded ones for the others), and the load
vector and errors fold the same way.  Setup-time work runs in float64 NumPy on the host; results are handed over
as tensors on the requested device (CUDA unless the caller asks for the
CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quadrature import gauss
from .operators import CellMatrix, CellMatrixSum

__all__ = ["mass_matrix", "laplace_matrix", "rhs_vector", "imm_mass_matrix",
           "imm_stiffness_matrix", "imm_rhs", "interpolate", "l2_error",
           "h1_error", "default_order", "vector_cell_dofs",
           "velocity_block_local", "elasticity_block_local",
           "divergence_block_local", "adaptive_matrix",
           "adaptive_vector_cell_matrix", "adaptive_mixed_cell_matrix"]


def default_order(space) -> int:
    return space.fe.degree + 1


def _ref_mass_local(fe, h, order) -> np.ndarray:
    rule = gauss(fe.dim, order)
    tab = fe.tabulate(rule.points)                      # (nq, nloc)
    vol = float(np.prod(h))
    return np.einsum("qa,qb,q->ab", tab, tab, rule.weights) * vol


def _ref_laplace_local(fe, h, order) -> np.ndarray:
    rule = gauss(fe.dim, order)
    grad = fe.tabulate_grad(rule.points)                # (nq, nloc, dim)
    vol = float(np.prod(h))
    out = np.zeros((fe.n_dofs_per_cell, fe.n_dofs_per_cell))
    for d in range(fe.dim):
        out += (vol / h[d] ** 2) * np.einsum(
            "qa,qb,q->ab", grad[:, :, d], grad[:, :, d], rule.weights)
    return out


def _adaptive(space) -> bool:
    return hasattr(space, "fold_of")


def mass_matrix(space, order=None, coef=None, *, device="cuda",
                dtype=torch.float64) -> CellMatrix:
    """Mass matrix of a uniform-grid space (one shared local matrix) or of
    a locally refined one (:func:`adaptive_matrix`)."""
    order = order or space.fe.degree + 1
    if _adaptive(space):
        return adaptive_matrix(
            space, space, lambda h: _ref_mass_local(space.fe, h, order),
            coef=coef, device=device, dtype=dtype)
    local = _ref_mass_local(space.fe, space.grid.h, order)
    return CellMatrix(space.cell_dofs, space.cell_dofs, local,
                      (space.n_dofs, space.n_dofs), coef, device=device,
                      dtype=dtype)


def laplace_matrix(space, order=None, coef=None, *, device="cuda",
                   dtype=torch.float64) -> CellMatrix:
    """Stiffness (grad u, grad v) of a uniform-grid space; ``coef`` is an
    optional per-cell constant (the elliptic-interface β field,
    elliptic_interface.cc:638-675)."""
    order = order or space.fe.degree + 1
    if _adaptive(space):
        return adaptive_matrix(
            space, space, lambda h: _ref_laplace_local(space.fe, h, order),
            coef=coef, device=device, dtype=dtype)
    local = _ref_laplace_local(space.fe, space.grid.h, order)
    return CellMatrix(space.cell_dofs, space.cell_dofs, local,
                      (space.n_dofs, space.n_dofs), coef, device=device,
                      dtype=dtype)


def rhs_vector(space, fn, order=None, *, device="cuda", dtype=torch.float64):
    """(f, φ_i) load vector of a background space: (n_dofs,) for a scalar
    ``fn``, (n_dofs, n_comp) for a vector one.  A scalar function on a
    Q1-continuous space takes the lattice form; every other case the
    element form (per-cell quadrature, host scatter), folded on a locally
    refined space."""
    order = order or default_order(space)
    if _adaptive(space):
        return torch.as_tensor(_adaptive_rhs(space, fn, order), dtype=dtype,
                               device=device)
    if space.fe.degree == 1 and space.continuous:
        out = _lattice_rhs(space, fn, order)
        if out is not None:
            return torch.as_tensor(out, dtype=dtype, device=device)
    return torch.as_tensor(_element_rhs(space, fn, order), dtype=dtype,
                           device=device)


def _element_rhs(space, fn, order: int) -> np.ndarray:
    """Element-form load vector: ``fn`` at every cell's quadrature points,
    weighted by the tabulated basis, scattered by the cell dof table."""
    rule, pts, jxw = _cell_quad_points(space, order)
    tab = space.fe.tabulate(rule.points)                # (nq, nloc)
    nc, nq, dim = pts.shape
    fv = np.asarray(fn(pts.reshape(-1, dim)), dtype=np.float64)
    w_tab = tab * jxw[:, None]
    dofs = space.cell_dofs.reshape(-1)
    if fv.ndim == 1:
        be = fv.reshape(nc, nq) @ w_tab                 # (nc, nloc)
        return np.bincount(dofs, weights=be.reshape(-1),
                           minlength=space.n_dofs)
    be = np.einsum("cqk,qa->cak", fv.reshape(nc, nq, -1), w_tab)
    return np.stack([np.bincount(dofs, weights=be[:, :, k].reshape(-1),
                                 minlength=space.n_dofs)
                     for k in range(be.shape[2])], axis=1)


def _vector_dofs(cell_dofs, n, n_comp):
    return np.concatenate([cell_dofs + c * n for c in range(n_comp)], axis=1)


def _block_fold(W, n_comp):
    """Block-diagonal fold of a component-major vector field."""
    if n_comp == 1:
        return W
    nc, nloc, K = W.shape
    Wv = np.zeros((nc, n_comp * nloc, n_comp * K))
    for c in range(n_comp):
        Wv[:, c * nloc:(c + 1) * nloc, c * K:(c + 1) * K] = W
    return Wv


def adaptive_matrix(row_space, col_space, local_fn, n_comp_row: int = 1,
                    n_comp_col: int = 1, coef=None, *, device="cuda",
                    dtype=torch.float64):
    """Element-form matrix on a locally refined grid (both spaces on the
    same tree): ``local_fn(h) -> (n_comp_row·nloc_row, n_comp_col·nloc_col)``
    is the local matrix of a cell of size h, component-major.  The
    reference folds every cell, ``W_rᵀ L W_c`` (``assembly.py:77-89,
    416-460``), and holds one (K, K) matrix a cell; here a cell without a
    hanging node in either space keeps its level's shared matrix on its
    first ``nloc`` dofs, one :class:`CellMatrix` a level, and only the
    constrained cells hold folded matrices: a :class:`CellMatrixSum` of the
    parts, the same matrix."""
    g = row_space.grid
    nl_r, nl_c = row_space.fe.n_dofs_per_cell, col_space.fe.n_dofs_per_cell
    n_r, n_c = row_space.n_dofs, col_space.n_dofs
    shape = (n_r * n_comp_row, n_c * n_comp_col)
    coef = None if coef is None else np.asarray(coef, dtype=np.float64)
    per_level = {int(l): local_fn(g.h_of_level(int(l)))
                 for l in np.unique(g.levels)}
    plain = row_space.plain & col_space.plain
    parts = []

    def part(sel, rows, cols, local):
        parts.append(CellMatrix(
            rows, cols, local, shape, None if coef is None else coef[sel],
            device=device, dtype=dtype))

    for lv, local in per_level.items():
        sel = np.flatnonzero(plain & (g.levels == lv))
        if len(sel):
            part(sel, _vector_dofs(row_space.cell_dofs[sel, :nl_r], n_r,
                                   n_comp_row),
                 _vector_dofs(col_space.cell_dofs[sel, :nl_c], n_c,
                              n_comp_col), local)
    constr = np.flatnonzero(~plain)
    if len(constr):
        L = np.stack([per_level[int(lv)] for lv in g.levels[constr]])
        Wr = _block_fold(row_space.fold_of(constr), n_comp_row)
        Wc = _block_fold(col_space.fold_of(constr), n_comp_col)
        part(constr, _vector_dofs(row_space.cell_dofs[constr], n_r,
                                  n_comp_row),
             _vector_dofs(col_space.cell_dofs[constr], n_c, n_comp_col),
             np.swapaxes(Wr, 1, 2) @ L @ Wc)
    return parts[0] if len(parts) == 1 else CellMatrixSum(parts, shape)


def adaptive_vector_cell_matrix(space, local_fn, n_comp: int, *,
                                device="cuda", dtype=torch.float64):
    """Vector operator on a locally refined space, ``local_fn(h) ->
    (nloc·n_comp, nloc·n_comp)`` (the Stokes velocity block,
    stokes_immersed_boundary.cc:472-483)."""
    return adaptive_matrix(space, space, local_fn, n_comp, n_comp,
                           device=device, dtype=dtype)


def adaptive_mixed_cell_matrix(row_space, col_space, local_fn,
                               n_comp_col: int, *, device="cuda",
                               dtype=torch.float64):
    """Scalar rows x vector columns on a locally refined pair (the Stokes
    divergence B), ``local_fn(h) -> (nloc_row, nloc_col·n_comp_col)``."""
    return adaptive_matrix(row_space, col_space, local_fn, 1, n_comp_col,
                           device=device, dtype=dtype)


def _adaptive_quad(space, order: int):
    """(rule, physical points (nc, nq, dim), JxW (nc, nq)) on a locally
    refined grid."""
    g = space.grid
    rule = gauss(g.dim, order)
    h = g.cell_h
    pts = g.cell_origins()[:, None, :] + rule.points[None, :, :] * h[:, None, :]
    jxw = rule.weights[None, :] * np.prod(h, axis=1)[:, None]
    return rule, pts, jxw


def _fold_scatter(space, be) -> np.ndarray:
    """Σ_c W_cᵀ be_c scattered to the free dofs: ``be`` is (nc, nloc) or
    (nc, nloc, k)."""
    nloc, K = space.fe.n_dofs_per_cell, space.cell_dofs.shape[1]
    bf = np.zeros((be.shape[0], K) + be.shape[2:])
    bf[:, :nloc] = be
    c = space.constrained
    if len(c):
        bf[c] = np.einsum("ca...,caK->cK...", be[c], space.fold_constrained)
    out = np.zeros((space.n_dofs,) + be.shape[2:])
    np.add.at(out, space.cell_dofs, bf)
    return out


def _local_values(space, u) -> np.ndarray:
    """(nc, nloc) local node values of a free-dof vector (the fold
    applied)."""
    nloc = space.fe.n_dofs_per_cell
    u = _host_vector(u)
    out = u[space.cell_dofs[:, :nloc]]
    c = space.constrained
    if len(c):
        out[c] = np.einsum("caK,cK->ca", space.fold_constrained,
                           u[space.cell_dofs[c]])
    return out


def _adaptive_rhs(space, fn, order: int) -> np.ndarray:
    rule, pts, jxw = _adaptive_quad(space, order)
    tab = space.fe.tabulate(rule.points)                 # (nq, nloc)
    nc, nq, dim = pts.shape
    fv = np.asarray(fn(pts.reshape(-1, dim)), dtype=np.float64)
    if fv.ndim == 2:                                      # vector fn
        be = np.einsum("cqk,qa,cq->cak", fv.reshape(nc, nq, -1), tab, jxw)
    else:
        be = np.einsum("cq,qa,cq->ca", fv.reshape(nc, nq), tab, jxw)
    return _fold_scatter(space, be)


def _lattice_rhs(space, fn, order: int):
    """Q1 load vector as shifted slice-adds on the node lattice: per quad
    point, f is evaluated on the cell lattice and distributed to the 2^dim
    cell corners (no per-cell dof table, no scatter).  Flat, float64; None
    for a vector ``fn`` (the element form takes it)."""
    grid = space.grid
    dim = grid.dim
    rule = gauss(dim, order)
    jxw = rule.weights * float(np.prod(grid.h))
    tab = space.fe.tabulate(rule.points)
    mi = space.fe.node_multi_indices
    nodes_shape = tuple(reversed(space.n_points_1d))
    cells_shape = tuple(reversed(grid.ncells))
    coords = [np.broadcast_to(
        np.arange(cells_shape[dim - 1 - d], dtype=np.float64).reshape(
            [-1 if ax == dim - 1 - d else 1 for ax in range(dim)]),
        cells_shape) for d in range(dim)]
    out = np.zeros(nodes_shape)
    for q in range(len(jxw)):
        pts = np.stack(
            [grid.origin[d] + (coords[d] + float(rule.points[q, d]))
             * float(grid.h[d]) for d in range(dim)], axis=-1)
        fv = np.asarray(fn(pts.reshape(-1, dim)))
        if fv.ndim != 1:
            return None
        fv = fv.reshape(cells_shape)
        for a in range(mi.shape[0]):
            off = tuple(int(mi[a, d]) for d in reversed(range(dim)))
            idx = tuple(slice(o, o + n) for o, n in zip(off, cells_shape))
            out[idx] += float(tab[q, a] * jxw[q]) * fv
    return out.reshape(-1)


def imm_mass_matrix(ispace, order=None, *, device="cuda",
                    dtype=torch.float64) -> CellMatrix:
    """Immersed mass matrix M (embedded_mass_matrix,
    immersed_laplace.cc:471)."""
    order = order or (ispace.fe.degree + 1)
    rule = gauss(ispace.mesh.dim, order)
    tab = ispace.fe.tabulate(rule.points)
    _, _, jxw = ispace.mesh.quad_geometry(rule)
    local = np.einsum("qa,qb,cq->cab", tab, tab, jxw)
    return CellMatrix(ispace.cell_dofs, ispace.cell_dofs, local,
                      (ispace.n_dofs, ispace.n_dofs), device=device,
                      dtype=dtype)


def imm_stiffness_matrix(ispace, order=None, *, device="cuda",
                         dtype=torch.float64) -> CellMatrix:
    """Immersed Laplace-Beltrami stiffness A_Γ through the first fundamental
    form (embedded_stiffness_matrix, immersed_laplace.cc:467; used by the
    rational preconditioner)."""
    order = order or (ispace.fe.degree + 1)
    rule = gauss(ispace.mesh.dim, order)
    grad = ispace.fe.tabulate_grad(rule.points)        # (nq, nloc, d)
    _, J, jxw = ispace.mesh.quad_geometry(rule)
    G = np.einsum("cqsd,cqse->cqde", J, J)
    Ginv = np.linalg.inv(G)
    local = np.einsum("qad,cqde,qbe,cq->cab", grad, Ginv, grad, jxw)
    return CellMatrix(ispace.cell_dofs, ispace.cell_dofs, local,
                      (ispace.n_dofs, ispace.n_dofs), device=device,
                      dtype=dtype)


def imm_rhs(ispace, fn, order=None, *, device="cuda", dtype=torch.float64):
    """(g, ψ_j)_Γ load vector on the immersed space: (n_imm,) for a scalar
    ``fn``, (n_imm, n_comp) for a vector one."""
    order = order or (ispace.fe.degree + 1)
    rule = gauss(ispace.mesh.dim, order)
    tab = ispace.fe.tabulate(rule.points)
    X, _, jxw = ispace.mesh.quad_geometry(rule)
    nc, nq, sd = X.shape
    fv = np.asarray(fn(X.reshape(-1, sd)))
    if fv.ndim == 1:
        be = np.einsum("cq,qa,cq->ca", fv.reshape(nc, nq), tab, jxw)
        out = np.zeros(ispace.n_dofs)
    else:
        be = np.einsum("cqk,qa,cq->cak", fv.reshape(nc, nq, -1), tab, jxw)
        out = np.zeros((ispace.n_dofs, be.shape[2]))
    np.add.at(out, ispace.cell_dofs, be)
    return torch.as_tensor(out, dtype=dtype, device=device)


def interpolate(space, fn, *, device="cuda", dtype=torch.float64):
    """Nodal interpolation (VectorTools::interpolate), host NumPy."""
    return torch.as_tensor(np.array(fn(space.dof_points)), dtype=dtype,
                           device=device)


def _cell_quad_points(space, order: int):
    """(rule, (nc, nq, dim) physical quadrature points, (nq,) JxW)."""
    rule = gauss(space.grid.dim, order)
    h = space.grid.h
    origins = (np.asarray(space.grid.origin)
               + space.grid.cell_multi_indices * h)
    pts = origins[:, None, :] + rule.points[None, :, :] * h
    return rule, pts, rule.weights * float(np.prod(h))


def _host_vector(u) -> np.ndarray:
    return torch.as_tensor(u).detach().cpu().double().numpy()


def l2_error(space, u, exact_fn, order=None) -> float:
    """||u_h - u||_L2 by Gauss quadrature on every background cell
    (VectorTools::integrate_difference), float64 on the host."""
    order = order or (space.fe.degree + 2)
    if _adaptive(space):
        rule, pts, jxw = _adaptive_quad(space, order)
        uh = _local_values(space, u) @ space.fe.tabulate(rule.points).T
        nc, nq, dim = pts.shape
        ex = np.asarray(exact_fn(pts.reshape(-1, dim))).reshape(nc, nq)
        return float(np.sqrt(np.sum((uh - ex) ** 2 * jxw)))
    rule, pts, jxw = _cell_quad_points(space, order)
    tab = space.fe.tabulate(rule.points)
    uh = _host_vector(u)[space.cell_dofs] @ tab.T
    nc, nq, dim = pts.shape
    ex = np.asarray(exact_fn(pts.reshape(-1, dim))).reshape(nc, nq)
    return float(np.sqrt(np.sum((uh - ex) ** 2 * jxw[None, :])))


def h1_error(space, u, exact_grad_fn, order=None) -> float:
    """H1-seminorm error ``||∇u_h - ∇u||_L2``; ``exact_grad_fn(points) ->
    (n, dim)``; float64 on the host."""
    order = order or (space.fe.degree + 2)
    if _adaptive(space):
        rule, pts, jxw = _adaptive_quad(space, order)
        nc, nq, dim = pts.shape
        gh = np.einsum("ca,qad->cqd", _local_values(space, u),
                       space.fe.tabulate_grad(rule.points)) / \
            space.grid.cell_h[:, None, :]
        ge = np.asarray(exact_grad_fn(pts.reshape(-1, dim))).reshape(
            nc, nq, dim)
        return float(np.sqrt(np.sum(np.sum((gh - ge) ** 2, axis=-1) * jxw)))
    rule, pts, jxw = _cell_quad_points(space, order)
    grad = space.fe.tabulate_grad(rule.points) / space.grid.h[None, None, :]
    nc, nq, dim = pts.shape
    gh = np.einsum("ca,qad->cqd", _host_vector(u)[space.cell_dofs], grad)
    ge = np.asarray(exact_grad_fn(pts.reshape(-1, dim))).reshape(nc, nq, dim)
    diff2 = np.sum((gh - ge) ** 2, axis=-1)
    return float(np.sqrt(np.sum(diff2 * jxw[None, :])))


# ---------------------------------------------------------------------------
# Vector-valued (Stokes) reference local matrices
# ---------------------------------------------------------------------------

def _grad_products(fe, h, order):
    """I[c, d, a, b] = ∫_cell ∂_c φ_a ∂_d φ_b dx on the uniform cell."""
    rule = gauss(fe.dim, order)
    phys = fe.tabulate_grad(rule.points) / np.asarray(h)[None, None, :]
    return np.einsum("qac,qbd,q->cdab", phys, phys,
                     rule.weights) * float(np.prod(h))


def _value_products(fe, h, order):
    """∫_cell φ_a φ_b dx on the uniform cell."""
    rule = gauss(fe.dim, order)
    tab = fe.tabulate(rule.points)
    return np.einsum("qa,qb,q->ab", tab, tab,
                     rule.weights) * float(np.prod(h))


def vector_cell_dofs(space, n_comp: int) -> np.ndarray:
    """(nc, nloc·n_comp) dofs of the component-major vector space:
    component c of scalar dof i is dof ``c·n_scalar + i``."""
    n = space.n_dofs
    return np.concatenate([space.cell_dofs + c * n for c in range(n_comp)],
                          axis=1)


def velocity_block_local(fe, h, order, grad_div_coef) -> np.ndarray:
    """(nloc·dim, nloc·dim) local matrix of the Stokes velocity block on the
    uniform cell (stokes_immersed_boundary.cc:722-744):
    ``(∇u : ∇v) + γ_gd (div u)(div v)`` when ``grad_div_coef`` is a number,
    ``2 (ε(u) : ε(v))`` when it is None."""
    dim = fe.dim
    nloc = fe.n_dofs_per_cell
    I = _grad_products(fe, h, order)                    # (dim, dim, a, b)
    lap = np.einsum("ccab->ab", I)
    out = np.zeros((nloc * dim, nloc * dim))
    for c in range(dim):
        for d in range(dim):
            blk = lap.copy() if c == d else np.zeros((nloc, nloc))
            if grad_div_coef is not None:
                blk = blk + grad_div_coef * I[c, d]     # div-div term
            else:
                blk = blk + I[d, c]                     # symmetric gradient
            out[c * nloc:(c + 1) * nloc, d * nloc:(d + 1) * nloc] = blk
    return out


def elasticity_block_local(fe, h, order, lam: float, mu: float) -> np.ndarray:
    """(nloc·dim, nloc·dim) local matrix of linear elasticity on the uniform
    cell, ``λ(div u, div v) + 2μ(ε(u) : ε(v))`` (the elasticity cell kernel,
    ElasticityUtilities::assemble_elasticity, utilities.h:377-427)."""
    dim = fe.dim
    nloc = fe.n_dofs_per_cell
    I = _grad_products(fe, h, order)                    # (dim, dim, a, b)
    lap = np.einsum("ccab->ab", I)
    out = np.zeros((nloc * dim, nloc * dim))
    for c in range(dim):
        for d in range(dim):
            blk = lam * I[c, d] + mu * I[d, c]
            if c == d:
                blk = blk + mu * lap
            out[c * nloc:(c + 1) * nloc, d * nloc:(d + 1) * nloc] = blk
    return out


def divergence_block_local(p_fe, u_fe, h, order) -> np.ndarray:
    """(nloc_p, nloc_u·dim) local matrix of B = -(div u, q)
    (stokes_immersed_boundary.cc:727-739)."""
    rule = gauss(u_fe.dim, order)
    p_tab = p_fe.tabulate(rule.points)                  # (nq, nloc_p)
    phys = (u_fe.tabulate_grad(rule.points)
            / np.asarray(h)[None, None, :])             # (nq, nloc_u, dim)
    vol = float(np.prod(h))
    return np.concatenate(
        [-vol * np.einsum("qa,qb,q->ab", p_tab, phys[:, :, c], rule.weights)
         for c in range(u_fe.dim)], axis=1)
