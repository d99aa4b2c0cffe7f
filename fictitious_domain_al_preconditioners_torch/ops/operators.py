"""Element-form operators and Dirichlet constraints.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.operators``:
``constrain``, ``dirichlet_rhs`` and :class:`CellMatrix`, the element-form
matrix (gather, batched local matvec, ``index_add_``), with a per-cell or a
shared local matrix and an optional per-cell coefficient, and
:class:`CellMatrixSum`, a sum of such matrices (the element form of a
locally refined grid: one shared local matrix per level for the cells
without a hanging node, per-cell folded ones for the others), and
:class:`CellRows`, a rank's rows of either.
"""

from __future__ import annotations

import numpy as np
import torch

from .linop import LinOp

__all__ = ["CellMatrix", "CellMatrixSum", "CellRows", "constrain",
           "dirichlet_rhs"]


class CellMatrix:
    """Element-form matrix
    ``A = sum_c P_row[c]^T (coef_c * local_c) P_col[c]``.

    ``local`` is per cell (nc, nloc_r, nloc_c) or shared by every cell
    (nloc_r, nloc_c), as the uniform background's matrices are; ``coef`` is
    an optional per-cell scaling.  The dof tables stay NumPy arrays on the
    host (``row_dofs_host``, ``col_dofs_host``) and go to ``device`` at the
    first apply, so a matrix whose apply a lattice stencil replaces (the
    background stiffness at millions of cells) never occupies the card;
    ``diag``, ``row_sums``, ``to_coo`` and ``to_dense`` are host setup work
    in float64."""

    def __init__(self, row_dofs, col_dofs, local, shape, coef=None, *,
                 device, dtype):
        self.row_dofs_host = np.asarray(row_dofs)
        self.col_dofs_host = np.asarray(col_dofs)
        self.local_host = np.asarray(local, dtype=np.float64)
        self.coef_host = (None if coef is None
                          else np.asarray(coef, dtype=np.float64))
        self.device = torch.device(device)
        self.dtype = dtype
        self.local = torch.as_tensor(self.local_host, dtype=dtype,
                                     device=self.device)
        self.coef = (None if coef is None else torch.as_tensor(
            self.coef_host, dtype=dtype, device=self.device))
        self.shape = tuple(shape)
        self._dofs = None

    def astype(self, dtype) -> "CellMatrix":
        """This matrix in ``dtype`` on its device (itself if it is
        already)."""
        if dtype == self.dtype:
            return self
        return CellMatrix(self.row_dofs_host, self.col_dofs_host,
                          self.local_host, self.shape, self.coef_host,
                          device=self.device, dtype=dtype)

    @property
    def shared_local(self) -> bool:
        return self.local_host.ndim == 2

    def _tables(self):
        if self._dofs is None:
            self._dofs = tuple(
                torch.as_tensor(a, dtype=torch.int64, device=self.device)
                for a in (self.row_dofs_host, self.col_dofs_host))
        return self._dofs

    @property
    def row_dofs(self) -> torch.Tensor:
        return self._tables()[0]

    @property
    def col_dofs(self) -> torch.Tensor:
        return self._tables()[1]

    def _local_as(self, x):
        # a bf16 input stays bf16
        return self.local.to(x.dtype)

    def mv(self, x):
        """``A @ x``; a trailing axis broadcasts: x may be (n,) or (n, k)."""
        rows, cols = self._tables()
        xe = x[cols]                             # (nc, nloc_c[, k])
        local = self._local_as(x)
        eq = ("ab,cb...->ca..." if self.shared_local
              else "cab,cb...->ca...")
        ye = torch.einsum(eq, local, xe)
        if self.coef is not None:
            ye = ye * self.coef.to(x.dtype).reshape(
                (-1,) + (1,) * (ye.dim() - 1))
        out = torch.zeros((self.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return out.index_add_(0, rows.reshape(-1),
                              ye.reshape((-1,) + tuple(x.shape[1:])))

    def rmv(self, y):
        """``Aᵀ @ y`` for a vector y of the row space."""
        rows, cols = self._tables()
        ye = y[rows]
        if self.coef is not None:
            ye = ye * self.coef.to(y.dtype)[:, None]
        local = self._local_as(y)
        xe = (ye @ local if self.shared_local
              else torch.einsum("cab,ca->cb", local, ye))
        out = torch.zeros(self.shape[1], dtype=y.dtype, device=y.device)
        return out.index_add_(0, cols.reshape(-1), xe.reshape(-1))

    def as_linop(self) -> LinOp:
        return LinOp(self.mv, self.shape, self.rmv)

    def _cell_values(self, loc):
        """(nc, nloc) per-cell values of a per-local-row reduction ``loc``
        ((nloc,) shared or (nc, nloc)), scaled by ``coef``."""
        vals = np.broadcast_to(loc, self.row_dofs_host.shape)
        if self.coef_host is not None:
            vals = vals * self.coef_host[:, None]
        return vals

    def _assemble_rows(self, loc) -> np.ndarray:
        vals = self._cell_values(loc)
        return np.bincount(self.row_dofs_host.reshape(-1),
                           weights=np.asarray(vals, dtype=np.float64)
                           .reshape(-1), minlength=self.shape[0])

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def diag_host(self) -> np.ndarray:
        """Assembled main diagonal in float64 NumPy (row and column spaces
        coincide)."""
        return self._assemble_rows(
            np.diagonal(self.local_host, axis1=-2, axis2=-1))

    def diag(self):
        """Assembled main diagonal, on the device in the matrix's dtype."""
        return self._on_device(self.diag_host())

    def row_sums(self):
        """Lumped-mass row sums (pressure mass lumping,
        stokes_immersed_boundary.cc:946-957)."""
        return self._on_device(self._assemble_rows(
            self.local_host.sum(axis=-1)))

    def to_coo(self):
        """(rows, cols, vals) as NumPy arrays, duplicates NOT summed."""
        row_dofs, col_dofs = self.row_dofs_host, self.col_dofs_host
        nc, nr = row_dofs.shape
        ncl = col_dofs.shape[1]
        rows = np.repeat(row_dofs, ncl, axis=1).reshape(-1)
        cols = np.tile(col_dofs, (1, nr)).reshape(-1)
        vals = (np.broadcast_to(self.local_host[None], (nc, nr, ncl))
                if self.shared_local else self.local_host)
        if self.coef_host is not None:
            vals = vals * self.coef_host[:, None, None]
        return rows, cols, np.asarray(vals).reshape(-1)

    def to_dense(self) -> np.ndarray:
        rows, cols, vals = self.to_coo()
        out = np.zeros(self.shape)
        np.add.at(out, (rows, cols), vals)
        return out


class CellMatrixSum:
    """``A = Σ_k parts[k]``, every part a :class:`CellMatrix` of the same
    shape: ``mv``, ``rmv``, ``diag_host``, ``row_sums``, ``to_dense`` and
    ``astype`` of :class:`CellMatrix`, summed over the parts."""

    def __init__(self, parts, shape):
        self.parts = list(parts)
        self.shape = tuple(shape)
        self.device = self.parts[0].device
        self.dtype = self.parts[0].dtype

    def astype(self, dtype) -> "CellMatrixSum":
        if dtype == self.dtype:
            return self
        return CellMatrixSum([p.astype(dtype) for p in self.parts],
                             self.shape)

    def mv(self, x):
        out = self.parts[0].mv(x)
        for p in self.parts[1:]:
            out = out + p.mv(x)
        return out

    def rmv(self, y):
        out = self.parts[0].rmv(y)
        for p in self.parts[1:]:
            out = out + p.rmv(y)
        return out

    def as_linop(self) -> LinOp:
        return LinOp(self.mv, self.shape, self.rmv)

    def diag_host(self) -> np.ndarray:
        return sum(p.diag_host() for p in self.parts)

    def row_sums(self):
        return sum(p.row_sums() for p in self.parts)

    def to_dense(self) -> np.ndarray:
        return sum(p.to_dense() for p in self.parts)



class CellRows:
    """Rows ``[first, last)`` of a :class:`CellMatrix` or
    :class:`CellMatrixSum` ``A``: ``mv(x)`` of the whole input vector is
    those rows of ``A x`` (a rank's rows of the sharded element form).  It
    keeps the cells with a row dof in the range; their other rows go to one
    extra output row, which ``mv`` drops."""

    def __init__(self, A, first: int, last: int):
        self.n = last - first
        self.shape = (self.n, A.shape[1])
        self.parts = []
        for p in getattr(A, "parts", [A]):
            rows = p.row_dofs_host.astype(np.int64)
            own = (rows >= first) & (rows < last)
            cells = own.any(axis=1)
            keep = torch.as_tensor(cells, device=p.device)
            self.parts.append((
                torch.as_tensor(np.where(own, rows - first, self.n)[cells],
                                dtype=torch.int64, device=p.device),
                torch.as_tensor(p.col_dofs_host[cells], dtype=torch.int64,
                                device=p.device),
                p.local if p.shared_local else p.local[keep],
                None if p.coef is None else p.coef[keep]))

    def mv(self, x):
        """Rows ``[first, last)`` of ``A @ x``; a trailing axis broadcasts.
        Each part sums into its own vector, as :class:`CellMatrixSum`'s
        do, so the rows round as the whole matrix's."""
        tail = tuple(x.shape[1:])
        out = None
        for rows, cols, local, coef in self.parts:
            eq = "ab,cb...->ca..." if local.dim() == 2 else "cab,cb...->ca..."
            ye = torch.einsum(eq, local.to(x.dtype), x[cols])
            if coef is not None:
                ye = ye * coef.to(x.dtype).reshape(
                    (-1,) + (1,) * (ye.dim() - 1))
            y = torch.zeros((self.n + 1,) + tail, dtype=x.dtype,
                            device=x.device).index_add_(
                0, rows.reshape(-1), ye.reshape((-1,) + tail))
            out = y if out is None else out + y
        return out[:self.n]

def constrain(op, free_mask: torch.Tensor) -> LinOp:
    """Impose Dirichlet constraints on a square operator:
    ``x -> P A P x + (I-P) x`` with ``P = diag(free_mask)``."""

    def mv(x):
        return torch.where(free_mask, op(torch.where(free_mask, x, 0.0)), x)

    return LinOp(mv, (free_mask.numel(), free_mask.numel()), mv)


def dirichlet_rhs(op, rhs, free_mask, boundary_values):
    """Lift inhomogeneous Dirichlet data: ``P (b - A g) + (I-P) g`` with
    ``g`` the boundary values extended by zero."""
    g = torch.where(free_mask, 0.0, boundary_values)
    return torch.where(free_mask, rhs - op(g), boundary_values)
