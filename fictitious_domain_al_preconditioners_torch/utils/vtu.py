"""Minimal VTU (VTK XML unstructured grid) writer.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.utils.vtu``
(deal.II ``DataOut::write_vtu``: immersed_laplace.cc:963-985,
stokes_immersed_boundary.cc:1115-1155, elliptic_interface.cc:1063-1082):
background fields (uniform or locally refined) and immersed-mesh fields for
ParaView, ASCII.  Field values may be NumPy arrays or tensors on any
device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_vtu", "write_vtu_background", "write_vtu_immersed",
           "export_matrix_csv"]

_VTK_QUAD = 9       # VTK_QUAD
_VTK_HEX = 12       # VTK_HEXAHEDRON
_VTK_LINE = 3       # VTK_LINE

# tensor-product (deal.II-style) corner order -> VTK node order
_VTK_ORDER = {1: [0, 1], 2: [0, 1, 3, 2], 3: [0, 1, 3, 2, 4, 5, 7, 6]}
_VTK_TYPE = {1: _VTK_LINE, 2: _VTK_QUAD, 3: _VTK_HEX}


def _host(v) -> np.ndarray:
    """A field as a float64 NumPy array (tensors leave their device)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().double().numpy()
    return np.asarray(v, dtype=np.float64)


def write_vtu(path: str, points: np.ndarray, cells: np.ndarray,
              cell_dim: int, point_data: dict | None = None):
    """points (n, spacedim<=3); cells (nc, 2^cell_dim) vertex ids in
    tensor-product order; point_data: name -> (n,) or (n, k) arrays."""
    points = np.asarray(points, dtype=float)
    n, sd = points.shape
    if sd < 3:
        points = np.concatenate(
            [points, np.zeros((n, 3 - sd))], axis=1)
    cells = np.asarray(cells, dtype=np.int64)[:, _VTK_ORDER[cell_dim]]
    nc, npc = cells.shape
    point_data = point_data or {}

    def arr2str(a, fmt="%.10g"):
        return " ".join(fmt % v for v in np.asarray(a).reshape(-1))

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{n}" NumberOfCells="{nc}">',
        "<Points>",
        '<DataArray type="Float64" NumberOfComponents="3" format="ascii">',
        arr2str(points),
        "</DataArray>",
        "</Points>",
        "<Cells>",
        '<DataArray type="Int64" Name="connectivity" format="ascii">',
        arr2str(cells, "%d"),
        "</DataArray>",
        '<DataArray type="Int64" Name="offsets" format="ascii">',
        arr2str(np.arange(1, nc + 1) * npc, "%d"),
        "</DataArray>",
        '<DataArray type="UInt8" Name="types" format="ascii">',
        arr2str(np.full(nc, _VTK_TYPE[cell_dim]), "%d"),
        "</DataArray>",
        "</Cells>",
        "<PointData>",
    ]
    for name, data in point_data.items():
        data = _host(data)
        ncomp = 1 if data.ndim == 1 else data.shape[1]
        lines += [
            f'<DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="ascii">',
            arr2str(data),
            "</DataArray>",
        ]
    lines += ["</PointData>", "</Piece>", "</UnstructuredGrid>", "</VTKFile>"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def write_vtu_background(path: str, space, point_data: dict):
    """Write a background solution (vertex-resolution patch: Q_k fields are
    written at the dof lattice using Q1 sub-cells, matching
    ``DataOut::build_patches(degree)``); on a locally refined space at every
    node, hanging nodes interpolated (``expand``)."""
    from ..core.grid import GridSpace as _GS, UniformGrid

    if hasattr(space, "expand"):       # locally refined background
        k, dim = space.fe.degree, space.grid.dim
        conn = []
        for s in range(k ** dim):      # Q1 sub-cells of the node lattice
            rest, base = s, []
            for d in range(dim):
                base.append(rest % k)
                rest //= k
            ids = []
            for c in range(2 ** dim):
                idx, stride = 0, 1
                for d in range(dim):
                    idx += (base[d] + ((c >> d) & 1)) * stride
                    stride *= k + 1
                ids.append(idx)
            conn.append(ids)
        cells = space._cell_nodes[:, np.asarray(conn)].reshape(-1, 2 ** dim)
        data = {k_: space.expand(_host(v)) for k_, v in point_data.items()}
        write_vtu(path, space._node_pos, cells, dim, data)
        return

    k = space.fe.degree
    fine = UniformGrid(space.grid.dim, space.grid.origin, space.grid.extent,
                       tuple(n * k for n in space.grid.ncells))
    # the Q1 lattice of the k-refined grid shares the Q_k dof numbering, so
    # its cell connectivity gives the sub-cell patches
    cells = _GS.q(fine, 1).cell_dofs
    write_vtu(path, space.dof_points, cells, space.grid.dim, point_data)


def write_vtu_immersed(path: str, ispace, point_data: dict):
    """Write immersed-mesh fields at dof support points (Q1 connectivity)."""
    from ..core.fe import FE

    mesh, fe = ispace.mesh, ispace.fe
    # Q1 sub-cells: the local dofs at each cell's corners
    loc = [int(np.linalg.norm(fe.node_points - c, axis=1).argmin())
           for c in FE(mesh.dim, 1).node_points]
    write_vtu(path, ispace.dof_points, ispace.cell_dofs[:, loc], mesh.dim,
              point_data)


def export_matrix_csv(path: str, dense_or_coo, limit: int = 1000):
    """MATLAB-CSV matrix export for offline eigen-analysis
    (``export_to_matlab_csv``, utilities.h:62-109): rows 'i,j,value'; skipped
    when larger than ``limit`` per side, matching the reference's guard."""
    a = dense_or_coo
    if hasattr(a, "rows"):  # COO
        if max(a.shape) > limit:
            return False
        with open(path, "w") as fh:
            for i, j, v in zip(a.rows, a.cols, a.vals):
                fh.write(f"{i + 1},{j + 1},{v:.16e}\n")
        return True
    a = np.asarray(a)
    if max(a.shape) > limit:
        return False
    with open(path, "w") as fh:
        for i in range(a.shape[0]):
            fh.write(",".join(f"{v:.16e}" for v in a[i]) + "\n")
    return True
