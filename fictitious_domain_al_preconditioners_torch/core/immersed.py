"""Immersed (embedded) meshes: small explicit meshes of the domain Γ.

TPU-native replacement for the reference's embedded ``Triangulation<dim,
spacedim>`` + ``MappingFEField``/``MappingQEulerian`` combination
(immersed_laplace.cc:296-323): a parametrized curve in 2D, a sphere surface in
3D, or a codim-0 region (elliptic_interface.cc:466-480).  The immersed side is
always *small* (10^2–10^4 dofs vs 10^6–10^7 background dofs), is replicated
across devices in the distributed path, and its entire geometry is precomputed
setup-time NumPy.

Representation: each cell carries
  - ``corner_keys``: coordinates of its 2^dim corners in a *dedup space* (the
    curve parameter, the cube-surface chart, or physical space).  Global dof
    identification for any-degree continuous spaces is done by multilinear
    interpolation of corner keys at local dof reference points + rounding —
    consistent across conforming neighbors because the interpolant restricted
    to a shared facet depends only on that facet's corners.
  - ``geom_nodes``: per-cell physical positions of the geometry (mapping) dofs,
    i.e. an isoparametric Q_m configuration field == deal.II MappingFEField on
    the "Embedded configuration" FE space.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import cached_property

import numpy as np

from .fe import FE
from .grid import UniformGrid
from .quadrature import GaussRule

__all__ = [
    "ImmersedMesh", "ImmersedSpace", "parametrized_curve", "hyper_sphere",
    "immersed_uniform_grid", "boundary_mesh", "hyper_ball",
]


def _dedup_keys(keys: np.ndarray, tol: float):
    """Row-dedup with tolerance -> (n_unique, inverse_index)."""
    q = np.round(keys / tol).astype(np.int64)
    _, index, inverse = np.unique(q, axis=0, return_index=True,
                                  return_inverse=True)
    return len(index), inverse.reshape(-1), index


@dataclass(frozen=True)
class ImmersedMesh:
    dim: int        # topological dimension of Γ
    spacedim: int   # embedding space dimension
    corner_keys: np.ndarray      # (nc, 2^dim, key_dim)
    geom_fe: FE                  # geometry (configuration) element
    geom_nodes: np.ndarray       # (nc, geom_fe.ndof, spacedim)
    chart: object = None         # optional callable keys (n, key_dim) -> (n, spacedim)

    @property
    def n_cells(self) -> int:
        return self.corner_keys.shape[0]

    @property
    def key_dim(self) -> int:
        return self.corner_keys.shape[2]

    def _interp_keys(self, ref_points: np.ndarray) -> np.ndarray:
        """Multilinear interpolation of corner keys at reference points.
        -> (nc, npts, key_dim)"""
        q1 = FE(self.dim, 1).tabulate(ref_points)  # (npts, 2^dim)
        return np.einsum("pn,cnk->cpk", q1, self.corner_keys)

    @cached_property
    def _key_tol(self) -> float:
        span = self.corner_keys.reshape(-1, self.key_dim)
        extent = max(float(span.max() - span.min()), 1.0)
        return 1e-8 * extent

    def dof_numbering(self, fe: FE):
        """Global dof ids for a continuous space -> (n_dofs, cell_dofs, rep_keys)."""
        keys = self._interp_keys(fe.node_points)  # (nc, nloc, kd)
        flat = keys.reshape(-1, self.key_dim)
        n, inverse, index = _dedup_keys(flat, self._key_tol)
        cell_dofs = inverse.reshape(self.n_cells, fe.n_dofs_per_cell).astype(np.int32)
        return n, cell_dofs, flat[index]

    def space(self, degree: int, continuous: bool = True) -> "ImmersedSpace":
        fe = FE(self.dim, degree, continuous)
        if continuous:
            n, cell_dofs, _ = self.dof_numbering(fe)
        else:
            nloc = fe.n_dofs_per_cell
            n = self.n_cells * nloc
            cell_dofs = np.arange(n, dtype=np.int32).reshape(self.n_cells, nloc)
        return ImmersedSpace(self, fe, cell_dofs, n)

    def quad_geometry(self, rule: GaussRule):
        """Quadrature geometry on every cell.

        Returns ``(X, J, jxw)`` with X (nc, nq, spacedim) physical points,
        J (nc, nq, spacedim, dim) jacobians, jxw (nc, nq) including the
        codim-aware metric ``sqrt(det(J^T J))``.  This is the TPU-native
        ``Particles::ParticleHandler`` / ``ALUtils::initialize_particles``
        quad-point table (utilities.h:755-837)."""
        tab = self.geom_fe.tabulate(rule.points)        # (nq, ng)
        grad = self.geom_fe.tabulate_grad(rule.points)  # (nq, ng, dim)
        X = np.einsum("qn,cns->cqs", tab, self.geom_nodes)
        J = np.einsum("qnd,cns->cqsd", grad, self.geom_nodes)
        G = np.einsum("cqsd,cqse->cqde", J, J)          # first fundamental form
        detG = np.linalg.det(G) if self.dim > 0 else np.ones(G.shape[:2])
        jxw = np.sqrt(np.maximum(detG, 0.0)) * rule.weights[None, :]
        return X, J, jxw

    def refine(self, times: int = 1) -> "ImmersedMesh":
        """Isotropic refinement: split each cell into 2^dim children.
        Geometry nodes are re-evaluated through ``chart`` when available
        (matching deal.II manifold-aware refinement), otherwise interpolated."""
        mesh = self
        for _ in range(times):
            mesh = mesh._refine_once()
        return mesh

    def _refine_once(self) -> "ImmersedMesh":
        dim = self.dim
        # children: sub-cubes with corners at {0,1/2}x... offsets
        child_corners = []  # (2^dim children, 2^dim corners, dim) ref coords
        corner_fe = FE(dim, 1)
        corner_ref = corner_fe.node_points  # (2^dim, dim)
        for child in range(2 ** dim):
            offs = np.array([(child >> d) & 1 for d in range(dim)]) * 0.5
            child_corners.append(offs + 0.5 * corner_ref)
        new_keys = []
        for cc in child_corners:
            new_keys.append(self._interp_keys(cc))  # (nc, 2^dim, kd)
        # interleave children per parent cell
        keys = np.stack(new_keys, axis=1).reshape(-1, 2 ** dim, self.key_dim)
        new_mesh = replace(self, corner_keys=keys,
                           geom_nodes=np.zeros((keys.shape[0],
                                                self.geom_fe.n_dofs_per_cell,
                                                self.spacedim)))
        return replace(new_mesh, geom_nodes=new_mesh._make_geom_nodes(self))

    def _make_geom_nodes(self, parent: "ImmersedMesh" = None) -> np.ndarray:
        gk = self._interp_keys(self.geom_fe.node_points)  # (nc, ng, kd)
        flat = gk.reshape(-1, self.key_dim)
        if self.chart is not None:
            phys = np.asarray(self.chart(flat))
        else:
            assert parent is not None
            # straight (Q1-interpolated) geometry from the parent mesh
            nchild = 2 ** self.dim
            ref = self.geom_fe.node_points
            out = np.empty((self.n_cells, ref.shape[0], self.spacedim))
            for child in range(nchild):
                offs = np.array([(child >> d) & 1 for d in range(self.dim)]) * 0.5
                pts = offs + 0.5 * ref
                tab = parent.geom_fe.tabulate(pts)  # (ng, ngp)
                out[child::nchild] = np.einsum("qn,cns->cqs", tab,
                                               parent.geom_nodes)
            return out
        return phys.reshape(self.n_cells, -1, self.spacedim)

    @cached_property
    def measure(self) -> float:
        """|Γ| by high-order quadrature (used by the sum(C)=|Γ| sanity check,
        nitsche_bcs.cc:467-490)."""
        from .quadrature import gauss
        _, _, jxw = self.quad_geometry(gauss(self.dim, max(self.geom_fe.degree + 1, 2)))
        return float(jxw.sum())

    @cached_property
    def h_max(self) -> float:
        """Max cell diameter (corner-to-corner), for mesh-ratio guards
        (immersed_laplace.cc:364-369)."""
        corners = self._interp_keys(FE(self.dim, 1).node_points)
        if self.chart is not None:
            phys = np.asarray(self.chart(corners.reshape(-1, self.key_dim)))
            phys = phys.reshape(self.n_cells, -1, self.spacedim)
        else:
            # corners are the first/last geometry nodes only for Q1; use geom bbox
            phys = self.geom_nodes
        lo, hi = phys.min(axis=1), phys.max(axis=1)
        return float(np.linalg.norm(hi - lo, axis=1).max())


@dataclass(frozen=True)
class ImmersedSpace:
    mesh: ImmersedMesh
    fe: FE
    cell_dofs: np.ndarray  # (nc, nloc) int32
    n_dofs: int

    @cached_property
    def dof_points(self) -> np.ndarray:
        """(n_dofs, spacedim) physical support points (via the geometry map)."""
        tab = self.mesh.geom_fe.tabulate(self.fe.node_points)  # (nloc, ng)
        pts = np.einsum("qn,cns->cqs", tab, self.mesh.geom_nodes)
        out = np.zeros((self.n_dofs, self.mesh.spacedim))
        out[self.cell_dofs.reshape(-1)] = pts.reshape(-1, self.mesh.spacedim)
        return out


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def parametrized_curve(config_fn, refinement: int, geom_degree: int = 1,
                       spacedim: int = 2) -> ImmersedMesh:
    """Embedded curve: unit-interval mesh [0,1] mapped by a configuration
    function (reference: embedded hyper_cube(1) + parsed "Embedded
    configuration", immersed_laplace.cc:296-323).  Non-periodic, matching the
    reference: a closed curve has distinct dofs at s=0 and s=1."""
    n = 2 ** refinement
    s = np.linspace(0.0, 1.0, n + 1)
    corner_keys = np.stack([s[:-1], s[1:]], axis=1)[:, :, None]  # (n, 2, 1)

    def chart(keys):
        pts = np.zeros((len(keys), spacedim))
        pts[:, 0] = keys[:, 0]
        vals = np.asarray(config_fn(pts))
        return vals.reshape(len(keys), spacedim)

    mesh = ImmersedMesh(1, spacedim, corner_keys, FE(1, geom_degree),
                        np.zeros((n, geom_degree + 1, spacedim)), chart)
    return replace(mesh, geom_nodes=mesh._make_geom_nodes())


def hyper_sphere(center, radius: float, refinement: int = 0,
                 geom_degree: int = 1) -> ImmersedMesh:
    """Sphere *surface* mesh in 3D (deal.II ``GridGenerator::hyper_sphere``,
    stokes_immersed_boundary.cc:424-431): 6-patch cube-sphere, refined with
    nodes projected to the sphere (== SphericalManifold refinement)."""
    center = np.asarray(center, dtype=float)
    # 6 faces of the cube [-1,1]^3, each a single cell; keys = cube coords.
    faces = []
    for d in range(3):
        for side in (-1.0, 1.0):
            u, v = [a for a in range(3) if a != d]
            corners = np.zeros((4, 3))
            # tensor order: (u fastest)
            uv = np.array([[-1, -1], [1, -1], [-1, 1], [1, 1]], dtype=float)
            corners[:, u] = uv[:, 0]
            corners[:, v] = uv[:, 1] * side  # flip to keep outward orientation
            corners[:, d] = side
            faces.append(corners)
    corner_keys = np.stack(faces)  # (6, 4, 3)

    def chart(keys):
        norm = np.linalg.norm(keys, axis=1, keepdims=True)
        return center + radius * keys / np.maximum(norm, 1e-300)

    mesh = ImmersedMesh(2, 3, corner_keys, FE(2, geom_degree),
                        np.zeros((6, (geom_degree + 1) ** 2, 3)), chart)
    mesh = replace(mesh, geom_nodes=mesh._make_geom_nodes())
    return mesh.refine(refinement)


def immersed_uniform_grid(grid: UniformGrid, geom_degree: int = 1) -> ImmersedMesh:
    """Codim-0 immersed region as an explicit mesh (elliptic interface problem:
    the immersed hyper_cube/hyper_rectangle, elliptic_interface.cc:466-480)."""
    h = grid.h
    origin = np.asarray(grid.origin)
    corners_ref = FE(grid.dim, 1).node_points  # (2^dim, dim)
    cells = grid.cell_multi_indices  # (nc, dim)
    corner_keys = origin + (cells[:, None, :] + corners_ref[None, :, :]) * h

    def chart(keys):
        return keys

    mesh = ImmersedMesh(grid.dim, grid.dim, corner_keys,
                        FE(grid.dim, geom_degree),
                        np.zeros((grid.n_cells, (geom_degree + 1) ** grid.dim,
                                  grid.dim)), chart)
    return replace(mesh, geom_nodes=mesh._make_geom_nodes())


def _refine_explicit_quads(vertices: np.ndarray, cells: np.ndarray,
                           snap_fn=None):
    """One isotropic refinement of an explicit 2D quad mesh.

    ``cells`` are vertex indices in tensor order (x fastest).  New vertices on
    *boundary* edges (edges shared by exactly one cell) are passed through
    ``snap_fn`` — the deal.II boundary-manifold behavior (SphericalManifold on
    the hyper_ball boundary)."""
    edges = {}
    edge_list = [(0, 1), (2, 3), (0, 2), (1, 3)]
    counts = {}
    for cell in cells:
        for a, b in edge_list:
            key = tuple(sorted((cell[a], cell[b])))
            counts[key] = counts.get(key, 0) + 1
    new_vertices = list(vertices)

    def edge_mid(i, j):
        key = tuple(sorted((i, j)))
        if key not in edges:
            mid = 0.5 * (vertices[i] + vertices[j])
            if snap_fn is not None and counts[key] == 1:
                mid = snap_fn(mid)
            edges[key] = len(new_vertices)
            new_vertices.append(mid)
        return edges[key]

    new_cells = []
    for cell in cells:
        v00, v10, v01, v11 = cell
        b = edge_mid(v00, v10)   # bottom mid
        t = edge_mid(v01, v11)   # top mid
        l = edge_mid(v00, v01)   # left mid
        r = edge_mid(v10, v11)   # right mid
        c = len(new_vertices)
        new_vertices.append(0.25 * (vertices[v00] + vertices[v10] +
                                    vertices[v01] + vertices[v11]))
        new_cells += [[v00, b, l, c], [b, v10, c, r],
                      [l, c, v01, t], [c, r, t, v11]]
    return np.array(new_vertices), np.array(new_cells, dtype=np.int64)


def hyper_ball(center, radius: float, refinement: int = 0) -> ImmersedMesh:
    """2D disk mesh (deal.II ``GridGenerator::hyper_ball``, used by the
    elliptic-interface convergence study, elliptic_interface.cc:460-461):
    5-cell coarse layout (central square + 4 ring cells), refined with
    boundary vertices projected to the circle."""
    center = np.asarray(center, dtype=float)
    d = radius / np.sqrt(2.0)
    b = d * 0.5
    verts = np.array([
        [-d, -d], [d, -d], [-d, d], [d, d],      # outer corners (on circle)
        [-b, -b], [b, -b], [-b, b], [b, b],      # inner square
    ])
    cells = np.array([
        [4, 5, 6, 7],        # center
        [0, 1, 4, 5],        # bottom
        [6, 7, 2, 3],        # top
        [0, 4, 2, 6],        # left
        [5, 1, 7, 3],        # right
    ], dtype=np.int64)

    def snap(p):
        return radius * p / np.linalg.norm(p)

    for _ in range(refinement):
        verts, cells = _refine_explicit_quads(verts, cells, snap_fn=snap)
    verts = verts + center
    corner_keys = verts[cells]  # (nc, 4, 2) — keys are physical coords
    mesh = ImmersedMesh(2, 2, corner_keys, FE(2, 1),
                        corner_keys.copy(), chart=None)
    return mesh


def boundary_mesh(grid: UniformGrid) -> ImmersedMesh:
    """Codim-1 mesh of the background cube's boundary (deal.II
    ``extract_boundary_mesh``, nitsche_bcs.cc:266-267).  Keys are physical
    coordinates, so corner/edge dofs are shared — the boundary space is
    continuous around the domain just like the reference's surface mesh."""
    dim = grid.dim
    origin = np.asarray(grid.origin)
    h = grid.h
    all_corner_keys = []
    for d in range(dim):
        for side in (0, 1):
            tang = [a for a in range(dim) if a != d]
            # cells of the (dim-1)-face grid
            shape = [grid.ncells[a] for a in tang]
            n_face_cells = int(np.prod(shape))
            idx = np.arange(n_face_cells)
            mi = np.empty((n_face_cells, dim - 1), dtype=np.int64)
            for i, a in enumerate(tang):
                mi[:, i] = idx % grid.ncells[a]
                idx = idx // grid.ncells[a]
            corners_ref = FE(dim - 1, 1).node_points  # (2^(dim-1), dim-1)
            keys = np.zeros((n_face_cells, corners_ref.shape[0], dim))
            for i, a in enumerate(tang):
                keys[:, :, a] = origin[a] + (mi[:, None, i] + corners_ref[None, :, i]) * h[a]
            keys[:, :, d] = origin[d] + side * grid.extent[d]
            all_corner_keys.append(keys)
    corner_keys = np.concatenate(all_corner_keys, axis=0)

    def chart(keys):
        return keys

    mesh = ImmersedMesh(dim - 1, dim, corner_keys, FE(dim - 1, 1),
                        np.zeros((corner_keys.shape[0], 2 ** (dim - 1), dim)),
                        chart)
    return replace(mesh, geom_nodes=mesh._make_geom_nodes())
