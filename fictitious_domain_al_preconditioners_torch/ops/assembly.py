"""FEM assembly for the immersed_laplace problem.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.assembly``
(the Q1 lattice load vector, the immersed mass and stiffness matrices and
load vector, nodal interpolation and the L2 error).  Setup-time work runs
in float64 NumPy on the host; results are handed over as tensors on the
requested device (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quadrature import gauss
from .operators import CellMatrix

__all__ = ["rhs_vector", "imm_mass_matrix", "imm_stiffness_matrix", "imm_rhs",
           "interpolate", "l2_error"]


def rhs_vector(space, fn, order=None, *, device="cuda", dtype=torch.float64):
    """(f, φ_i) load vector of a Q1-continuous background space."""
    order = order or space.fe.degree + 1
    if not (space.fe.degree == 1 and space.continuous):
        raise NotImplementedError("only the Q1 lattice load vector is ported")
    return torch.as_tensor(_lattice_rhs(space, fn, order), dtype=dtype,
                           device=device)


def _lattice_rhs(space, fn, order: int) -> np.ndarray:
    """Q1 load vector as shifted slice-adds on the node lattice: per quad
    point, f is evaluated on the cell lattice and distributed to the 2^dim
    cell corners (no per-cell dof table, no scatter).  Flat, float64."""
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
        fv = np.asarray(fn(pts.reshape(-1, dim))).reshape(cells_shape)
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
    """(g, ψ_j)_Γ load vector on the immersed space (scalar ``fn``)."""
    order = order or (ispace.fe.degree + 1)
    rule = gauss(ispace.mesh.dim, order)
    tab = ispace.fe.tabulate(rule.points)
    X, _, jxw = ispace.mesh.quad_geometry(rule)
    nc, nq, sd = X.shape
    fv = np.asarray(fn(X.reshape(-1, sd)))
    be = np.einsum("cq,qa,cq->ca", fv.reshape(nc, nq), tab, jxw)
    out = np.zeros(ispace.n_dofs)
    np.add.at(out, ispace.cell_dofs, be)
    return torch.as_tensor(out, dtype=dtype, device=device)


def interpolate(space, fn, *, device="cuda", dtype=torch.float64):
    """Nodal interpolation (VectorTools::interpolate), host NumPy."""
    return torch.as_tensor(np.array(fn(space.dof_points)), dtype=dtype,
                           device=device)


def l2_error(space, u, exact_fn, order=None) -> float:
    """||u_h - u||_L2 by Gauss quadrature on every background cell
    (VectorTools::integrate_difference), float64 on the host."""
    order = order or (space.fe.degree + 2)
    rule = gauss(space.grid.dim, order)
    h = space.grid.h
    origins = (np.asarray(space.grid.origin)
               + space.grid.cell_multi_indices * h)
    pts = origins[:, None, :] + rule.points[None, :, :] * h
    jxw = rule.weights * float(np.prod(h))
    tab = space.fe.tabulate(rule.points)
    u_np = torch.as_tensor(u).detach().cpu().double().numpy()
    uh = u_np[space.cell_dofs] @ tab.T
    nc, nq, dim = pts.shape
    ex = np.asarray(exact_fn(pts.reshape(-1, dim))).reshape(nc, nq)
    return float(np.sqrt(np.sum((uh - ex) ** 2 * jxw[None, :])))
