"""Structured background grids and their finite element spaces.

The reference always uses ``hyper_cube``/``hyper_rectangle`` *background*
domains (immersed_laplace.cc:284, stokes_immersed_boundary.cc:417,
elliptic_interface grid generator args ``-1: 1: true``).  The TPU-native design
exploits this: the background is an *implicit uniform tensor-product grid*, so

  - point location is O(1) index arithmetic (``floor((x-x0)/h)``) — a gather,
    replacing deal.II's rtree ``GridTools::compute_point_locations``;
  - geometric multigrid coarsening is trivially available (replacing ML-AMG);
  - domain decomposition over the TPU device mesh is a block partition.

Global continuous Q_k dofs live on a lattice of ``k*n+1`` points per dimension,
numbered lexicographically (first coordinate fastest).  Face/boundary-id
convention matches deal.II colorized hyper_cubes: ``2d`` = min face in
dimension ``d``, ``2d+1`` = max face.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .fe import FE, DGPElement

__all__ = ["UniformGrid", "GridSpace"]


@dataclass(frozen=True)
class UniformGrid:
    dim: int
    origin: tuple
    extent: tuple
    ncells: tuple

    @classmethod
    def hyper_cube(cls, dim: int, left: float = 0.0, right: float = 1.0,
                   refinement: int = 0) -> "UniformGrid":
        """deal.II ``GridGenerator::hyper_cube`` + ``refine_global(refinement)``."""
        n = 2 ** refinement
        return cls(dim, (left,) * dim, (right - left,) * dim, (n,) * dim)

    @classmethod
    def hyper_rectangle(cls, p1, p2, refinement: int = 0) -> "UniformGrid":
        p1 = np.asarray(p1, dtype=float)
        p2 = np.asarray(p2, dtype=float)
        n = 2 ** refinement
        return cls(len(p1), tuple(p1), tuple(p2 - p1), (n,) * len(p1))

    def refine(self, times: int = 1) -> "UniformGrid":
        f = 2 ** times
        return UniformGrid(self.dim, self.origin, self.extent,
                           tuple(n * f for n in self.ncells))

    def coarsen(self, times: int = 1) -> "UniformGrid":
        f = 2 ** times
        assert all(n % f == 0 for n in self.ncells), "grid not coarsenable"
        return UniformGrid(self.dim, self.origin, self.extent,
                           tuple(n // f for n in self.ncells))

    @property
    def h(self) -> np.ndarray:
        return np.asarray(self.extent) / np.asarray(self.ncells)

    @property
    def h_min(self) -> float:
        return float(self.h.min())

    @property
    def h_max(self) -> float:
        return float(self.h.max())

    @property
    def cell_diameter(self) -> float:
        return float(np.linalg.norm(self.h))

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.ncells))

    @cached_property
    def cell_multi_indices(self) -> np.ndarray:
        """(n_cells, dim) multi-index of every cell, first coordinate fastest."""
        idx = np.arange(self.n_cells)
        out = np.empty((self.n_cells, self.dim), dtype=np.int64)
        for d in range(self.dim):
            out[:, d] = idx % self.ncells[d]
            idx = idx // self.ncells[d]
        return out

    @property
    def cell_volume(self) -> float:
        return float(np.prod(self.h))

    def cell_centers(self) -> np.ndarray:
        return np.asarray(self.origin) + (self.cell_multi_indices + 0.5) * self.h

    def locate(self, points: np.ndarray):
        """Locate physical points: -> (linear cell index (n,), ref coords (n, dim)).

        O(1) index arithmetic; replaces deal.II's rtree point location
        (GridTools::Cache + compute_point_locations, utilities.h:775-837)."""
        points = np.atleast_2d(np.asarray(points, dtype=float))
        rel = (points - np.asarray(self.origin)) / self.h
        mi = np.clip(np.floor(rel).astype(np.int64), 0,
                     np.asarray(self.ncells) - 1)
        ref = rel - mi
        strides = np.cumprod([1] + list(self.ncells[:-1]))
        return (mi @ strides).astype(np.int64), ref


@dataclass(frozen=True)
class GridSpace:
    """A (possibly discontinuous) scalar FE space on a UniformGrid.

    Vector-valued spaces (Stokes velocity, elasticity displacement) are
    represented as ``(ndofs, n_comp)`` arrays over this scalar space —
    component-blocked, mirroring deal.II's component-wise renumbering
    (stokes_immersed_boundary.cc:533-541)."""

    grid: UniformGrid
    fe: object  # FE or DGPElement

    @classmethod
    def q(cls, grid: UniformGrid, degree: int) -> "GridSpace":
        return cls(grid, FE(grid.dim, degree, True))

    @classmethod
    def dgq(cls, grid: UniformGrid, degree: int) -> "GridSpace":
        return cls(grid, FE(grid.dim, degree, False))

    @classmethod
    def dgp(cls, grid: UniformGrid, degree: int = 1) -> "GridSpace":
        assert degree == 1
        return cls(grid, DGPElement(grid.dim))

    @property
    def continuous(self) -> bool:
        return self.fe.continuous

    @cached_property
    def n_points_1d(self) -> tuple:
        k = self.fe.degree
        return tuple(k * n + 1 for n in self.grid.ncells)

    @property
    def n_dofs(self) -> int:
        if self.continuous:
            return int(np.prod(self.n_points_1d))
        return self.grid.n_cells * self.fe.n_dofs_per_cell

    @cached_property
    def cell_dofs(self) -> np.ndarray:
        """(n_cells, n_dofs_per_cell) global dof indices, int32."""
        nloc = self.fe.n_dofs_per_cell
        if not self.continuous:
            return np.arange(self.grid.n_cells * nloc,
                             dtype=np.int32).reshape(self.grid.n_cells, nloc)
        k = self.fe.degree
        npts = self.n_points_1d
        strides = np.cumprod([1] + list(npts[:-1]))
        mi = self.fe.node_multi_indices  # (nloc, dim)
        cells = self.grid.cell_multi_indices  # (ncell, dim)
        per_dim = cells[:, None, :] * k + mi[None, :, :]  # (ncell, nloc, dim)
        return (per_dim @ strides).astype(np.int32)

    @cached_property
    def dof_points(self) -> np.ndarray:
        """(ndofs, dim) physical support-point coordinates of every dof."""
        origin = np.asarray(self.grid.origin)
        h = self.grid.h
        if not self.continuous:
            # per-cell node points
            cells = self.grid.cell_multi_indices  # (ncell, dim)
            if hasattr(self.fe, "node_points"):
                local = self.fe.node_points  # (nloc, dim)
            else:  # DGP: use cell centers for all local dofs
                local = np.full((self.fe.n_dofs_per_cell, self.grid.dim), 0.5)
            pts = origin + (cells[:, None, :] + local[None, :, :]) * h
            return pts.reshape(-1, self.grid.dim)
        k = self.fe.degree
        nodes = self.fe.nodes_1d
        coords_1d = []
        for d in range(self.grid.dim):
            p = np.arange(self.n_points_1d[d])
            c = np.minimum(p // k, self.grid.ncells[d] - 1)
            a = p - c * k
            coords_1d.append(origin[d] + (c + nodes[a]) * h[d])
        grids = np.meshgrid(*coords_1d, indexing="ij")
        return np.stack([g.reshape(-1, order="F") for g in grids], axis=-1)

    def boundary_dof_mask(self, boundary_ids=None) -> np.ndarray:
        """Boolean (ndofs,) mask of dofs on the listed boundary faces.

        Face ids: 2d = min face of dim d, 2d+1 = max face (deal.II colorize).
        ``None`` selects the whole boundary.  Replaces
        ``AffineConstraints`` Dirichlet rows (immersed_laplace.cc:381-386)."""
        assert self.continuous, "Dirichlet masks only for continuous spaces"
        if boundary_ids is None:
            boundary_ids = list(range(2 * self.grid.dim))
        npts = self.n_points_1d
        dim = self.grid.dim
        idx = np.arange(self.n_dofs)
        mi = []
        for d in range(dim):
            mi.append(idx % npts[d])
            idx = idx // npts[d]
        mask = np.zeros(self.n_dofs, dtype=bool)
        for bid in boundary_ids:
            d, side = bid // 2, bid % 2
            if d >= dim:
                continue
            target = 0 if side == 0 else npts[d] - 1
            mask |= mi[d] == target
        return mask

    def coarse_space(self, times: int = 1) -> "GridSpace":
        """Same element on a 2^times-coarsened grid (for geometric multigrid)."""
        return GridSpace(self.grid.coarsen(times), self.fe)
