"""Tensor-product Lagrange finite elements on the reference cube ``[0,1]^dim``.

TPU-native replacement for deal.II ``FE_Q(k)`` / ``FE_DGQ(k)`` / ``FE_DGP(1)``
(reference usage: immersed_laplace.cc:416-425, stokes_immersed_boundary.cc:513-529).
Tabulation (values/gradients at quadrature points *and at arbitrary reference
points*, the latter needed for non-matching coupling) is setup-time NumPy; the
resulting arrays are constants baked into jitted kernels.

Local dof ordering is lexicographic with the first coordinate fastest — this is
a framework-internal convention (deal.II's hierarchic numbering spans the same
space; no behavior depends on the ordering).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["FE", "lagrange_nodes_1d", "lagrange_values_1d", "lagrange_derivs_1d", "DGPElement"]


def lagrange_nodes_1d(degree: int) -> np.ndarray:
    """Support points on [0,1]: Gauss-Lobatto (== equispaced for k <= 2),
    matching deal.II FE_Q's default support points."""
    if degree == 0:
        return np.array([0.5])
    if degree == 1:
        return np.array([0.0, 1.0])
    if degree == 2:
        return np.array([0.0, 0.5, 1.0])
    # interior Gauss-Lobatto nodes = roots of P'_degree on [-1,1]
    interior = np.polynomial.legendre.Legendre.basis(degree).deriv().roots()
    nodes = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    return (nodes + 1.0) / 2.0


def lagrange_values_1d(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Values of the 1D Lagrange basis at points ``x`` -> (len(x), len(nodes))."""
    x = np.asarray(x, dtype=float)
    n = len(nodes)
    out = np.ones((len(x), n))
    for j in range(n):
        for m in range(n):
            if m != j:
                out[:, j] *= (x - nodes[m]) / (nodes[j] - nodes[m])
    return out


def lagrange_derivs_1d(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """First derivatives of the 1D Lagrange basis at ``x`` -> (len(x), n)."""
    x = np.asarray(x, dtype=float)
    n = len(nodes)
    out = np.zeros((len(x), n))
    for j in range(n):
        denom = np.prod([nodes[j] - nodes[m] for m in range(n) if m != j]) if n > 1 else 1.0
        for m in range(n):
            if m == j:
                continue
            term = np.ones(len(x))
            for l in range(n):
                if l != j and l != m:
                    term *= x - nodes[l]
            out[:, j] += term / denom
    return out


@dataclass(frozen=True)
class FE:
    """Q_k tensor-product Lagrange element on [0,1]^dim.

    ``continuous=False`` marks the DG variant (FE_DGQ) — same local basis,
    different global dof numbering (handled by the space classes).
    """

    dim: int
    degree: int
    continuous: bool = True
    nodes_1d: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "nodes_1d", lagrange_nodes_1d(self.degree))

    @property
    def n_dofs_per_cell(self) -> int:
        return (self.degree + 1) ** self.dim

    @property
    def node_multi_indices(self) -> np.ndarray:
        """(ndof, dim) lattice index of each local dof (first coord fastest)."""
        n1 = self.degree + 1
        idx = np.arange(self.n_dofs_per_cell)
        out = np.empty((self.n_dofs_per_cell, self.dim), dtype=np.int64)
        for d in range(self.dim):
            out[:, d] = idx % n1
            idx = idx // n1
        return out

    @property
    def node_points(self) -> np.ndarray:
        """(ndof, dim) reference coordinates of the local dofs."""
        return self.nodes_1d[self.node_multi_indices]

    def tabulate(self, points: np.ndarray) -> np.ndarray:
        """Basis values at reference ``points`` (n, dim) -> (n, ndof)."""
        points = np.atleast_2d(points)
        vals1d = [lagrange_values_1d(self.nodes_1d, points[:, d]) for d in range(self.dim)]
        mi = self.node_multi_indices
        out = np.ones((points.shape[0], self.n_dofs_per_cell))
        for d in range(self.dim):
            out *= vals1d[d][:, mi[:, d]]
        return out

    def tabulate_grad(self, points: np.ndarray) -> np.ndarray:
        """Basis gradients at reference ``points`` -> (n, ndof, dim)."""
        points = np.atleast_2d(points)
        vals1d = [lagrange_values_1d(self.nodes_1d, points[:, d]) for d in range(self.dim)]
        ders1d = [lagrange_derivs_1d(self.nodes_1d, points[:, d]) for d in range(self.dim)]
        mi = self.node_multi_indices
        out = np.ones((points.shape[0], self.n_dofs_per_cell, self.dim))
        for g in range(self.dim):
            for d in range(self.dim):
                tab = ders1d[d] if d == g else vals1d[d]
                out[:, :, g] *= tab[:, mi[:, d]]
        return out


@dataclass(frozen=True)
class DGPElement:
    """P_1 discontinuous element (deal.II FE_DGP(1), the Q2-P1disc Stokes
    pressure: stokes_immersed_boundary.cc:517-529).  Basis on [0,1]^dim:
    ``{1, x-1/2, y-1/2, (z-1/2)}`` — spans the same space as deal.II's
    Legendre-type basis."""

    dim: int

    @property
    def degree(self) -> int:
        return 1

    @property
    def continuous(self) -> bool:
        return False

    @property
    def n_dofs_per_cell(self) -> int:
        return self.dim + 1

    def tabulate(self, points: np.ndarray) -> np.ndarray:
        points = np.atleast_2d(points)
        cols = [np.ones(points.shape[0])]
        for d in range(self.dim):
            cols.append(points[:, d] - 0.5)
        return np.stack(cols, axis=-1)

    def tabulate_grad(self, points: np.ndarray) -> np.ndarray:
        points = np.atleast_2d(points)
        out = np.zeros((points.shape[0], self.n_dofs_per_cell, self.dim))
        for d in range(self.dim):
            out[:, 1 + d, d] = 1.0
        return out
