"""Element-form operators and Dirichlet constraints.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.operators``:
``constrain`` and ``dirichlet_rhs``, plus a minimal :class:`CellMatrix`
(``mv``, ``diag``, ``to_coo``) that holds the immersed mass and stiffness
matrices.
"""

from __future__ import annotations

import numpy as np
import torch

from .linop import LinOp

__all__ = ["CellMatrix", "constrain", "dirichlet_rhs"]


class CellMatrix:
    """Element-form matrix ``A = sum_c P_row[c]^T local_c P_col[c]`` with
    per-cell local matrices ``local`` (nc, nloc_r, nloc_c)."""

    def __init__(self, row_dofs, col_dofs, local, shape, *, device, dtype):
        self.row_dofs = torch.as_tensor(row_dofs, dtype=torch.int64,
                                        device=device)
        self.col_dofs = torch.as_tensor(col_dofs, dtype=torch.int64,
                                        device=device)
        self.local = torch.as_tensor(local, dtype=dtype, device=device)
        self.shape = tuple(shape)

    def mv(self, x):
        """``A @ x``; a trailing axis broadcasts: x may be (n,) or (n, k)."""
        xe = x[self.col_dofs]                   # (nc, nloc_c[, k])
        local = self.local.to(x.dtype)          # a bf16 input stays bf16
        if xe.dim() == 3:
            ye = torch.einsum("cab,cbk->cak", local, xe)
        else:
            ye = torch.einsum("cab,cb->ca", local, xe)
        out = torch.zeros((self.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return out.index_add_(0, self.row_dofs.reshape(-1),
                              ye.reshape((-1,) + tuple(x.shape[1:])))

    def diag(self):
        """Assembled main diagonal (row and column spaces coincide)."""
        d_loc = torch.diagonal(self.local, dim1=1, dim2=2)
        out = torch.zeros(self.shape[0], dtype=self.local.dtype,
                          device=self.local.device)
        return out.index_add_(0, self.row_dofs.reshape(-1), d_loc.reshape(-1))

    def to_coo(self):
        """(rows, cols, vals) as NumPy arrays, duplicates NOT summed."""
        row_dofs = self.row_dofs.cpu().numpy()
        col_dofs = self.col_dofs.cpu().numpy()
        nr, ncl = row_dofs.shape[1], col_dofs.shape[1]
        rows = np.repeat(row_dofs, ncl, axis=1).reshape(-1)
        cols = np.tile(col_dofs, (1, nr)).reshape(-1)
        return rows, cols, self.local.cpu().numpy().reshape(-1)


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
