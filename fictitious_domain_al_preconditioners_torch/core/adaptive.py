"""Adaptively refined background grids (local refinement near Γ).

Counterpart of ``fictitious_domain_al_preconditioners_tpu.core.adaptive``
(host NumPy there too): deal.II's flagged local refinement with
``AffineConstraints`` hanging-node handling (the ``delta_refinement`` loop,
immersed_laplace.cc:328-343 and stokes_immersed_boundary.cc:468-483: cells
holding Γ support points and their face neighbours are refined, the mesh is
2:1-balanced and hanging nodes are constrained).

- The mesh is a 2:1-balanced quadtree (2D) or octree (3D) over the
  hyper-cube: a flat array of leaves ``(level, ij)``; neighbour lookup and
  point location are vectorised integer arithmetic on encoded keys.
- Hanging-node constraints are resolved transitively and folded into the
  element dof lists: each leaf carries padded free-dof indices ``cell_dofs``
  and a fold matrix ``W_c`` with ``u_local = W_c u_free``.  Solvers work in
  the conforming free-dof space.
- Coarser multigrid levels are the same tree clamped one level at a time,
  down to the uniform base grid.

The leaves, the node numbering, the free dofs, ``cell_dofs`` and the folds
are those of the reference package.  What differs is how they are held, so
that a 4M-cell tree sets up in seconds: nodes are numbered by sorting one
integer key per node of the finest lattice instead of ``np.unique`` over
rows of rounded coordinates (the same order), and the fold is kept for the
constrained cells only (``fold_constrained``), every other cell's being the
identity; the dense ``fold_w`` of every cell is built on request.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .fe import FE, DGPElement, lagrange_values_1d

__all__ = ["AdaptiveGrid", "AdaptiveSpace", "AdaptiveDGPSpace"]

_LEVEL_CAP = 30


def _bits(dim: int) -> int:
    return 56 // dim


def _encode(dim: int, levels, ij) -> np.ndarray:
    b = _bits(dim)
    key = np.asarray(levels, dtype=np.int64)
    for d in range(dim):
        key = (key << b) | np.asarray(ij[..., d], dtype=np.int64)
    return key


@dataclass(frozen=True)
class AdaptiveGrid:
    """A 2:1-balanced tree of leaf cells over ``[origin, origin+extent]``.

    Level-``l`` cells tile the domain ``2^l`` per dimension; ``ij`` is the
    integer multi-index of each leaf at its own level."""

    dim: int
    origin: tuple
    extent: tuple
    levels: np.ndarray  # (nc,) int32
    ij: np.ndarray      # (nc, dim) int64

    @classmethod
    def uniform(cls, dim: int, level: int, origin=None, extent=None
                ) -> "AdaptiveGrid":
        origin = tuple(origin) if origin is not None else (0.0,) * dim
        extent = tuple(extent) if extent is not None else (1.0,) * dim
        n = 1 << level
        idx = np.arange(n ** dim)
        ij = np.empty((n ** dim, dim), dtype=np.int64)
        for d in range(dim):
            ij[:, d] = idx % n
            idx //= n
        return cls(dim, origin, extent,
                   np.full(n ** dim, level, dtype=np.int32), ij)

    # -- basic queries --------------------------------------------------------

    @property
    def n_cells(self) -> int:
        return len(self.levels)

    @property
    def max_level(self) -> int:
        return int(self.levels.max())

    @property
    def min_level(self) -> int:
        return int(self.levels.min())

    def h_of_level(self, level) -> np.ndarray:
        """Cell size at a level: (dim,) or (n, dim) for an array of levels."""
        ext = np.asarray(self.extent)
        lv = np.asarray(level)
        return ext / (1 << lv)[..., None] if lv.ndim else ext / (1 << int(lv))

    @property
    def cell_h(self) -> np.ndarray:
        """(nc, dim) per-leaf cell size."""
        return self.h_of_level(self.levels)

    @property
    def h_min(self) -> float:
        return float((np.asarray(self.extent) / (1 << self.max_level)).min())

    @property
    def min_cell_diameter(self) -> float:
        """GridTools::minimal_cell_diameter (immersed_laplace.cc:355)."""
        return float(np.linalg.norm(
            np.asarray(self.extent) / (1 << self.max_level)))

    def cell_origins(self) -> np.ndarray:
        return np.asarray(self.origin) + self.ij * self.cell_h

    @cached_property
    def _sorted_keys(self):
        keys = _encode(self.dim, self.levels, self.ij)
        order = np.argsort(keys)
        return keys[order], order

    # -- leaf lookup ----------------------------------------------------------

    def find_leaf(self, levels_q, ij_q):
        """Leaf covering each query cell ``(level, ij)`` (query level >= leaf
        level) by a vectorised ancestor walk-up: ``(leaf_index,
        leaf_level)``, index -1 where no leaf covers the query."""
        levels_q = np.asarray(levels_q, dtype=np.int64)
        ij_q = np.asarray(ij_q, dtype=np.int64)
        if levels_q.ndim == 0:
            levels_q = np.broadcast_to(levels_q, (ij_q.shape[0],))
        skeys, order = self._sorted_keys
        out_idx = np.full(len(ij_q), -1, dtype=np.int64)
        out_lvl = np.full(len(ij_q), -1, dtype=np.int64)
        pending = np.arange(len(ij_q))
        for shift in range(self.max_level + 1):
            if len(pending) == 0:
                break
            lev = levels_q[pending] - shift
            ok = lev >= 0
            pend_ok = pending[ok]
            if len(pend_ok) == 0:
                break
            cand = _encode(self.dim, lev[ok], ij_q[pend_ok] >> shift)
            pos = np.searchsorted(skeys, cand)
            hit = (pos < len(skeys)) & (skeys[np.minimum(pos, len(skeys) - 1)]
                                        == cand)
            hits = pend_ok[hit]
            out_idx[hits] = order[pos[hit]]
            out_lvl[hits] = levels_q[hits] - shift
            pending = pend_ok[~hit]
        return out_idx, out_lvl

    def locate(self, points: np.ndarray):
        """Physical points -> (leaf index (n,), reference coords (n, dim)):
        fine-lattice index arithmetic and the ancestor walk-up
        (GridTools::compute_point_locations on a tree)."""
        points = np.atleast_2d(np.asarray(points, dtype=float))
        L = self.max_level
        hf = np.asarray(self.extent) / (1 << L)
        rel = (points - np.asarray(self.origin)) / hf
        fine = np.clip(np.floor(rel).astype(np.int64), 0, (1 << L) - 1)
        idx, _ = self.find_leaf(np.full(len(points), L), fine)
        assert (idx >= 0).all(), "point outside the leaf cover"
        h = self.h_of_level(self.levels[idx])
        org = np.asarray(self.origin) + self.ij[idx] * h
        ref = np.clip((points - org) / h, 0.0, 1.0)
        return idx, ref

    # -- refinement -----------------------------------------------------------

    def refine(self, flags: np.ndarray) -> "AdaptiveGrid":
        """Replace flagged leaves by their 2^dim children, then restore 2:1
        balance (deal.II execute_coarsening_and_refinement)."""
        return self._split(flags)._balance()

    def _split(self, flags: np.ndarray) -> "AdaptiveGrid":
        flags = np.asarray(flags, dtype=bool)
        if not flags.any():
            return self
        assert self.levels[flags].max() < _LEVEL_CAP
        keep_l, keep_ij = self.levels[~flags], self.ij[~flags]
        pl, pij = self.levels[flags], self.ij[flags]
        offs = np.empty((1 << self.dim, self.dim), dtype=np.int64)
        idx = np.arange(1 << self.dim)
        for d in range(self.dim):
            offs[:, d] = (idx >> d) & 1
        ch_ij = (pij[:, None, :] * 2 + offs[None, :, :]).reshape(-1, self.dim)
        ch_l = np.repeat(pl + 1, 1 << self.dim).astype(np.int32)
        return AdaptiveGrid(self.dim, self.origin, self.extent,
                            np.concatenate([keep_l, ch_l]),
                            np.concatenate([keep_ij, ch_ij]))

    def _balance_offsets(self):
        """Neighbour offsets of the 2:1 balance: the 4 face neighbours in 2D;
        all 26 in 3D, so that every hanging node lies on a face against a
        neighbour exactly one level coarser (what the face-based constraint
        discovery of :class:`AdaptiveSpace` needs)."""
        if self.dim == 2:
            offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
        else:
            offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                    for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0)]
        return np.asarray(offs, dtype=np.int64)

    def _balance(self) -> "AdaptiveGrid":
        g = self
        offsets = self._balance_offsets()
        while True:
            flags = np.zeros(g.n_cells, dtype=bool)
            for l in range(g.max_level, 1, -1):
                sel = np.flatnonzero(g.levels == l)
                if len(sel) == 0:
                    continue
                for off in offsets:
                    nij = g.ij[sel] + off[None, :]
                    inside = np.all((nij >= 0) & (nij < (1 << l)), axis=1)
                    idx, lvl = g.find_leaf(l, nij[inside])
                    bad = (idx >= 0) & (lvl < l - 1)
                    flags[idx[bad]] = True
            if not flags.any():
                return g
            g = g._split(flags)

    def refine_near(self, points: np.ndarray) -> "AdaptiveGrid":
        """One delta-refinement step: flag the leaves holding the points and
        their face neighbours, refine, re-balance
        (immersed_laplace.cc:332-343)."""
        idx, _ = self.locate(points)
        flags = np.zeros(self.n_cells, dtype=bool)
        flags[idx] = True
        hit = np.unique(idx)
        lv, ij = self.levels[hit].astype(np.int64), self.ij[hit]
        for d in range(self.dim):
            for step in (-1, 1):
                nij = ij.copy()
                nij[:, d] += step
                inside = (nij[:, d] >= 0) & (nij[:, d] < (1 << lv))
                nidx, _ = self.find_leaf(lv[inside], nij[inside])
                flags[nidx[nidx >= 0]] = True
        return self.refine(flags)

    # -- coarsening (multigrid hierarchy) --------------------------------------

    def coarsen(self) -> "AdaptiveGrid":
        """Clamp the deepest level by one (merge its sibling groups); a
        clamped 2:1-balanced tree stays balanced."""
        L = self.max_level
        assert L > 0
        deep = self.levels == L
        parents = np.unique(_encode(self.dim, np.full(int(deep.sum()), L - 1),
                                    self.ij[deep] >> 1))
        b = _bits(self.dim)
        pij = np.empty((len(parents), self.dim), dtype=np.int64)
        rest = parents
        for d in range(self.dim - 1, -1, -1):
            pij[:, d] = rest & ((1 << b) - 1)
            rest >>= b
        return AdaptiveGrid(
            self.dim, self.origin, self.extent,
            np.concatenate([self.levels[~deep],
                            np.full(len(parents), L - 1, dtype=np.int32)]),
            np.concatenate([self.ij[~deep], pij]))


class AdaptiveSpace:
    """Continuous Q_k space on an :class:`AdaptiveGrid` with hanging nodes
    eliminated: ``n_dofs`` (free dofs), ``cell_dofs`` (padded free-dof
    indices), ``fe``, ``dof_points``, ``boundary_dof_mask``, ``tabulate_at``
    (folded basis at arbitrary points, for the coupling table and the
    multigrid prolongation), ``expand``, ``can_coarsen`` and
    ``coarse_space``.  The fold: ``plain`` marks the cells without a hanging
    node (fold = identity on the first ``nloc`` columns), ``constrained``
    lists the others and ``fold_constrained`` their folds."""

    continuous = True

    def __init__(self, grid: AdaptiveGrid, degree: int):
        assert grid.dim in (2, 3), "adaptive refinement: quadtree/octree"
        self.grid = grid
        self.fe = FE(grid.dim, degree, True)
        self._setup_nodes()
        self._setup_constraints()
        self._setup_fold()

    # -- node enumeration -----------------------------------------------------

    def _setup_nodes(self):
        """Number the nodes of every cell, sorted by x, then y (then z), the
        order of the reference's ``np.unique`` over rounded coordinates;
        each node's position is that of its first occurrence, as there."""
        g, fe = self.grid, self.fe
        h = g.cell_h                                      # (nc, dim)
        org = g.cell_origins()
        mi = fe.node_multi_indices                        # (nloc, dim)
        frac = fe.nodes_1d[mi]
        pos = org[:, None, :] + frac[None, :, :] * h[:, None, :]
        self._tol = g.h_min * 1e-7
        flat = pos.reshape(-1, g.dim)
        k = fe.degree
        L = g.max_level
        equispaced = np.allclose(fe.nodes_1d * k, np.arange(k + 1))
        if equispaced:
            # integer coordinates on the finest node lattice: exact, and
            # ordered as the rounded coordinates are
            scale = (1 << (L - g.levels.astype(np.int64)))[:, None, None]
            lat = (g.ij[:, None, :] * k + mi[None, :, :]) * scale
            n1 = k * (1 << L) + 1
            key = np.zeros(lat.shape[:2], dtype=np.int64)
            for d in range(g.dim):
                key = key * n1 + lat[:, :, d]
            key = key.reshape(-1)
            order = np.argsort(key, kind="stable")
            ks = key[order]
            first = np.concatenate([[True], ks[1:] != ks[:-1]])
            index = order[first]
            inverse = np.empty(len(key), dtype=np.int64)
            inverse[order] = np.cumsum(first) - 1
        else:
            q = np.round(flat / self._tol).astype(np.int64)
            _, index, inverse = np.unique(q, axis=0, return_index=True,
                                          return_inverse=True)
        self._node_pos = flat[index]                      # (N, dim)
        self._cell_nodes = inverse.reshape(
            g.n_cells, fe.n_dofs_per_cell).astype(np.int64)

    # -- hanging-node constraints ----------------------------------------------

    def _setup_constraints(self):
        g, fe = self.grid, self.fe
        k = fe.degree
        mi = fe.node_multi_indices                        # (nloc, dim)
        constraints: dict[int, list] = {}

        for d in range(g.dim):
            tdims = [t for t in range(g.dim) if t != d]  # tangential dims
            for side in (0, 1):
                face_loc = np.flatnonzero(mi[:, d] == (k if side else 0))
                opp_loc = np.flatnonzero(mi[:, d] == (0 if side else k))
                # masters sorted lexicographically over the tangential dims
                # (first tangential dim slowest), the weights' layout
                opp_loc = opp_loc[np.lexsort(
                    tuple(mi[opp_loc, t] for t in reversed(tdims)))]
                # leaves whose (d, side) face neighbour is coarser
                lv = g.levels.astype(np.int64)
                nij = g.ij.copy()
                nij[:, d] += 1 if side else -1
                inside = (nij[:, d] >= 0) & (nij[:, d] < (1 << lv))
                cand = np.flatnonzero(inside)
                nidx, nlvl = g.find_leaf(lv[cand], nij[cand])
                coarse = (nidx >= 0) & (nlvl == lv[cand] - 1)
                for c, nb in zip(cand[coarse], nidx[coarse]):
                    slaves = self._cell_nodes[c][face_loc]
                    masters = self._cell_nodes[nb][opp_loc]
                    # each slave's tangential position on the coarse face in
                    # the coarse cell's reference coordinates; the weight is
                    # the tensor product of the 1D Lagrange values
                    hnb = g.h_of_level(int(g.levels[nb]))
                    wts = np.ones((len(slaves), 1))
                    for t in tdims:
                        o_t = g.origin[t] + g.ij[nb][t] * hnb[t]
                        tt = (self._node_pos[slaves][:, t] - o_t) / hnb[t]
                        w1 = lagrange_values_1d(fe.nodes_1d, tt)
                        wts = (wts[:, :, None] * w1[:, None, :]).reshape(
                            len(slaves), -1)
                    for s_id, w in zip(slaves, wts):
                        # a slave on a coarse node is that node (merged by
                        # the numbering), not hanging
                        if np.max(np.abs(w - (np.abs(w) > 0.5))) < 1e-12 and \
                                np.count_nonzero(np.abs(w) > 0.5) == 1:
                            continue
                        if s_id not in constraints:
                            constraints[s_id] = [
                                (int(m), float(ww))
                                for m, ww in zip(masters, w)
                                if abs(ww) > 1e-14]

        # transitive resolution: a master can itself hang on a yet-coarser
        # neighbour (AffineConstraints::close)
        for _ in range(g.max_level + 2):
            dirty = False
            for s, terms in list(constraints.items()):
                if any(m in constraints for m, _ in terms):
                    new = {}
                    for m, w in terms:
                        if m in constraints:
                            for m2, w2 in constraints[m]:
                                new[m2] = new.get(m2, 0.0) + w * w2
                        else:
                            new[m] = new.get(m, 0.0) + w
                    constraints[s] = [(m, w) for m, w in new.items()
                                      if abs(w) > 1e-14]
                    dirty = True
            if not dirty:
                break
        else:  # pragma: no cover
            raise RuntimeError("hanging-node constraint chain did not resolve")

        self._constraints = constraints
        n_nodes = len(self._node_pos)
        is_slave = np.zeros(n_nodes, dtype=bool)
        if constraints:
            is_slave[np.fromiter(constraints, dtype=np.int64)] = True
        self._free_of_node = np.cumsum(~is_slave) - 1
        self._free_of_node[is_slave] = -1
        self._is_slave = is_slave
        self.n_dofs = int((~is_slave).sum())
        self.dof_points = self._node_pos[~is_slave]

    # -- constraint fold --------------------------------------------------------

    def _setup_fold(self):
        """Per-cell padded free dofs and the folds of the constrained cells:
        ``u_local = W_c u_free``."""
        g, fe = self.grid, self.fe
        nloc = fe.n_dofs_per_cell
        cn = self._cell_nodes
        cell_has_slave = self._is_slave[cn].any(axis=1)
        constr = np.flatnonzero(cell_has_slave)

        rows = []  # (dofs (K_c,), W (nloc, K_c)) per constrained cell
        kmax = nloc
        for c in constr:
            terms: dict[int, np.ndarray] = {}
            for a, node in enumerate(cn[c]):
                if self._is_slave[node]:
                    for m, w in self._constraints[node]:
                        fi = int(self._free_of_node[m])
                        terms.setdefault(fi, np.zeros(nloc))[a] += w
                else:
                    fi = int(self._free_of_node[node])
                    terms.setdefault(fi, np.zeros(nloc))[a] += 1.0
            dofs = np.fromiter(terms, dtype=np.int64)
            W = np.stack([terms[int(dd)] for dd in dofs], axis=1)
            rows.append((dofs, W))
            kmax = max(kmax, len(dofs))

        K = kmax
        cell_dofs = np.zeros((g.n_cells, K), dtype=np.int32)
        cell_dofs[:, :nloc] = np.where(cell_has_slave[:, None], 0,
                                       self._free_of_node[cn])
        fold = np.zeros((len(constr), nloc, K))
        for i, (c, (dofs, W)) in enumerate(zip(constr, rows)):
            cell_dofs[c, :] = 0
            cell_dofs[c, :len(dofs)] = dofs
            fold[i, :, :len(dofs)] = W
        self.cell_dofs = cell_dofs
        self.plain = ~cell_has_slave
        self.constrained = constr
        self.fold_constrained = fold
        self.n_constrained_cells = len(constr)

    def fold_of(self, cells) -> np.ndarray:
        """(n, nloc, K) folds of the given cells."""
        cells = np.asarray(cells)
        nloc, K = self.fe.n_dofs_per_cell, self.cell_dofs.shape[1]
        out = np.zeros((len(cells), nloc, K))
        out[:, np.arange(nloc), np.arange(nloc)] = 1.0
        pos = np.searchsorted(self.constrained, cells)
        hit = ~self.plain[cells]
        out[hit] = self.fold_constrained[pos[hit]]
        return out

    @property
    def fold_w(self) -> np.ndarray:
        """(nc, nloc, K) fold of every cell (the reference's dense form)."""
        return self.fold_of(np.arange(self.grid.n_cells))

    # -- the GridSpace surface ---------------------------------------------------

    def boundary_dof_mask(self, boundary_ids=None) -> np.ndarray:
        """Free dofs on the listed outer-boundary faces (deal.II colorize
        ids: 2d = min face of dim d, 2d+1 = max face)."""
        if boundary_ids is None:
            boundary_ids = list(range(2 * self.grid.dim))
        pts = self.dof_points
        o = np.asarray(self.grid.origin)
        e = np.asarray(self.grid.extent)
        mask = np.zeros(self.n_dofs, dtype=bool)
        for bid in boundary_ids:
            d, side = bid // 2, bid % 2
            if d >= self.grid.dim:
                continue
            target = o[d] + (e[d] if side else 0.0)
            mask |= np.abs(pts[:, d] - target) < self._tol
        return mask

    def tabulate_at(self, points: np.ndarray):
        """Folded basis at physical points -> (padded free dofs (n, K),
        folded values (n, K)): NonMatching::create_coupling_* with
        constraints and MGTransfer in one."""
        cells, refs = self.grid.locate(points)
        phi = self.fe.tabulate(refs)                      # (n, nloc)
        nloc, K = phi.shape[1], self.cell_dofs.shape[1]
        vals = np.zeros((len(cells), K))
        vals[:, :nloc] = phi
        hit = ~self.plain[cells]
        if hit.any():
            pos = np.searchsorted(self.constrained, cells[hit])
            vals[hit] = np.einsum("na,naK->nK", phi[hit],
                                  self.fold_constrained[pos])
        return self.cell_dofs[cells], vals

    def expand(self, u_free: np.ndarray) -> np.ndarray:
        """Free-dof vector -> values at all nodes, hanging nodes interpolated
        (AffineConstraints::distribute)."""
        u_free = np.asarray(u_free)
        out = np.zeros(len(self._node_pos), dtype=u_free.dtype)
        out[~self._is_slave] = u_free
        for s, terms in self._constraints.items():
            out[s] = sum(w * u_free[self._free_of_node[m]] for m, w in terms)
        return out

    def can_coarsen(self, min_cells: int = 4) -> bool:
        return (1 << (self.grid.max_level - 1)) >= min_cells

    def coarse_space(self) -> "AdaptiveSpace":
        return AdaptiveSpace(self.grid.coarsen(), self.fe.degree)


class AdaptiveDGPSpace:
    """Discontinuous P_1 modal space on an :class:`AdaptiveGrid`: the
    Q2-P1disc Stokes pressure under ``delta_refinement``
    (stokes_immersed_boundary.cc:517-529).  No inter-cell continuity, so no
    constraints: every cell is ``plain``."""

    continuous = False

    def __init__(self, grid: AdaptiveGrid, degree: int = 1):
        assert degree == 1
        assert grid.dim in (2, 3)
        self.grid = grid
        self.fe = DGPElement(grid.dim)
        nloc = self.fe.n_dofs_per_cell
        nc = grid.n_cells
        self.n_dofs = nc * nloc
        self.cell_dofs = np.arange(self.n_dofs,
                                   dtype=np.int32).reshape(nc, nloc)
        self.plain = np.ones(nc, dtype=bool)
        self.constrained = np.zeros(0, dtype=np.int64)
        self.fold_constrained = np.zeros((0, nloc, nloc))
        self.n_constrained_cells = 0

    def fold_of(self, cells) -> np.ndarray:
        nloc = self.fe.n_dofs_per_cell
        return np.broadcast_to(np.eye(nloc), (len(cells), nloc, nloc)).copy()

    @property
    def fold_w(self) -> np.ndarray:
        return self.fold_of(np.arange(self.grid.n_cells))

    @cached_property
    def dof_points(self) -> np.ndarray:
        """Cell centres, repeated per local modal dof (moment dofs have no
        nodal position)."""
        centers = self.grid.cell_origins() + 0.5 * self.grid.cell_h
        return np.repeat(centers, self.fe.n_dofs_per_cell, axis=0)

    def boundary_dof_mask(self, boundary_ids=None) -> np.ndarray:
        return np.zeros(self.n_dofs, dtype=bool)

    def tabulate_at(self, points: np.ndarray):
        cells, refs = self.grid.locate(points)
        return self.cell_dofs[cells], self.fe.tabulate(refs)

    def can_coarsen(self, min_cells: int = 4) -> bool:
        return (1 << (self.grid.max_level - 1)) >= min_cells

    def coarse_space(self) -> "AdaptiveDGPSpace":
        return AdaptiveDGPSpace(self.grid.coarsen(), self.fe.degree)
