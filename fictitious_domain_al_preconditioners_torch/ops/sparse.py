"""Sparse (COO) algebra: deduplication, transpose, SpGEMM, materialization.

Copy of ``fictitious_domain_al_preconditioners_tpu.ops.sparse`` (host NumPy
there too): the reference's explicit sparse plumbing (N12),
deal.II ``SparseMatrix::mmult`` with diagonal scaling (immersed_laplace.cc:815),
``Epetra_RowMatrixTransposer`` (utilities.h:131-177) and
``compute_mmult_pattern``.  The default compute path is operator-form
(matrix-free); this module provides the *explicit* materialization the
reference uses to feed AMG and for offline eigen-analysis
(``build_AMG_augmented_block*``, utilities.h:111-331, 591-744):

    Aug = K + γ · Cᵀ diag(w) C      (explicit SpGEMM over COO triplets)

All routines are host-side NumPy (setup-time); sorted-COO with segment-sums
replaces pointer-chasing sparse kernels.
"""

from __future__ import annotations

import numpy as np

__all__ = ["COO", "coo_dedup", "coo_transpose", "spgemm_ctwc",
           "augmented_block_coo"]


class COO:
    """Sorted, deduplicated COO matrix (host-side)."""

    def __init__(self, rows, cols, vals, shape):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.vals = np.asarray(vals, dtype=np.float64)
        self.shape = tuple(shape)

    @classmethod
    def from_triplets(cls, rows, cols, vals, shape) -> "COO":
        r, c, v = coo_dedup(rows, cols, vals, shape[1])
        return cls(r, c, v, shape)

    @classmethod
    def from_cell_matrix(cls, cm) -> "COO":
        rows, cols, vals = cm.to_coo()
        return cls.from_triplets(rows, cols, vals, cm.shape)

    @classmethod
    def from_coupling(cls, coupling) -> "COO":
        rows, cols, vals = coupling.to_coo()
        return cls.from_triplets(rows, cols, vals, coupling.shape)

    @property
    def nnz(self) -> int:
        return len(self.vals)

    def T(self) -> "COO":
        return coo_transpose(self)

    def diag(self) -> np.ndarray:
        out = np.zeros(self.shape[0])
        m = self.rows == self.cols
        np.add.at(out, self.rows[m], self.vals[m])
        return out

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        out[self.rows, self.cols] = self.vals
        return out

    def mv(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros(self.shape[0])
        np.add.at(out, self.rows, self.vals * x[self.cols])
        return out

    def add(self, other: "COO", alpha: float = 1.0) -> "COO":
        assert self.shape == other.shape
        return COO.from_triplets(
            np.concatenate([self.rows, other.rows]),
            np.concatenate([self.cols, other.cols]),
            np.concatenate([self.vals, alpha * other.vals]), self.shape)

    def linfty_norm(self) -> float:
        sums = np.zeros(self.shape[0])
        np.add.at(sums, self.rows, np.abs(self.vals))
        return float(sums.max()) if len(sums) else 0.0


def coo_dedup(rows, cols, vals, ncols: int):
    """Sort by (row, col) and sum duplicates — the COO equivalent of deal.II's
    ``distribute_local_to_global`` accumulation."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    key = rows * np.int64(ncols) + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    vals_s = vals[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(key_s)) + 1])
    v = np.add.reduceat(vals_s, starts)
    k = key_s[starts]
    return k // ncols, k % ncols, v


def coo_transpose(a: COO) -> COO:
    """Transpose by index swap + re-sort (replaces Epetra_RowMatrixTransposer,
    utilities.h:131-177)."""
    r, c, v = coo_dedup(a.cols, a.rows, a.vals, a.shape[0])
    return COO(r, c, v, (a.shape[1], a.shape[0]))


def spgemm_ctwc(c: COO, w_diag: np.ndarray) -> COO:
    """Cᵀ·diag(w)·C for a coupling COO C (n_imm x n_bg) -> (n_bg x n_bg).

    Row-expansion SpGEMM: group C's entries by row (immersed dof j), form the
    outer products w_j · C[j,:]ᵀ C[j,:] and dedup — the reference's
    ``mmult(BtWinvB, coupling_t, inverse_squares)`` (immersed_laplace.cc:815,
    utilities.h:214-218)."""
    rows, cols, vals = coo_dedup(c.rows, c.cols, c.vals, c.shape[1])
    starts = np.concatenate([[0], np.flatnonzero(np.diff(rows)) + 1,
                             [len(rows)]])
    if len(rows) == 0:
        return COO(np.zeros(0), np.zeros(0), np.zeros(0),
                   (c.shape[1], c.shape[1]))
    lens = np.diff(starts)
    out_r, out_c, out_v = [], [], []
    # batch rows of equal nnz: one (g, k, k) outer-product sweep per length
    # class instead of a Python loop over every immersed dof (the loop was
    # O(n_imm) interpreter time — minutes at the reference's 8-cycle scale)
    for k in np.unique(lens):
        sel = np.flatnonzero(lens == k)
        idx = starts[sel][:, None] + np.arange(k)[None, :]   # (g, k)
        cj = cols[idx]                                       # (g, k)
        vj = vals[idx]
        wj = w_diag[rows[starts[sel]]]                       # (g,)
        out_r.append(np.repeat(cj, k, axis=1).reshape(-1))
        out_c.append(np.tile(cj, (1, k)).reshape(-1))
        out_v.append((wj[:, None, None] * vj[:, :, None]
                      * vj[:, None, :]).reshape(-1))
    return COO.from_triplets(np.concatenate(out_r), np.concatenate(out_c),
                             np.concatenate(out_v),
                             (c.shape[1], c.shape[1]))


def augmented_block_coo(k_cm, coupling, w_diag, gamma: float) -> COO:
    """Explicit augmented block Aug = K + γ·Cᵀdiag(w)C as deduplicated COO —
    the materialization behind ``build_AMG_augmented_block_scalar``
    (utilities.h:591-744), available for diagnostics/eigen-export."""
    K = COO.from_cell_matrix(k_cm)
    C = COO.from_coupling(coupling)
    return K.add(spgemm_ctwc(C, np.asarray(w_diag)), alpha=gamma)
