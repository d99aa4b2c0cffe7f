"""Inverse-weight (W⁻¹) operators for the AL term γ·CᵀW⁻¹C.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.precond.weights``.
The reference offers several immersed mass-matrix surrogates W (SURVEY §0):
M (exact UMFPACK inverse), M² (exact inverse applied twice), diag(M),
diag(M)², diag(M²), and h-scaled M (W = M/h²).  The exact inverses are the
tensor-product banded inverse on a uniform Q1 lattice
(:func:`lattice_mass_inverse`), a dense inverse built once on the host up to
:data:`DENSE_INV_MAX` dofs, and Jacobi-CG above.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.krylov import cg
from ..ops.linop import LinOp, diag_op

__all__ = ["DENSE_INV_MAX", "inv_diag", "inv_diag_squared", "inv_exact",
           "inv_squared_exact", "inv_diag_of_m_squared",
           "diag_of_m_squared", "lattice_mass_inverse"]

# Immersed matrices up to this size get a dense inverse computed once on the
# host in float64 and applied as one matmul (the reference's factor once,
# solve cheaply UMFPACK pattern).
DENSE_INV_MAX = 4096


def inv_diag(M) -> LinOp:
    """W = diag(M) (operator-form immersed_laplace, lines 856-863).  ``M`` is
    anything with ``diag()``, e.g. an ``ops.operators.CellMatrix``."""
    return diag_op(1.0 / M.diag())


def inv_diag_squared(M) -> LinOp:
    """W = diag(M)² (explicit-form immersed_laplace lines 869-874; Stokes
    'Diagonal mass immersed', stokes_immersed_boundary.cc:965-973)."""
    return diag_op(1.0 / M.diag() ** 2)


def _lattice_1d_mass(n: int, h: float) -> np.ndarray:
    """1D Q1 mass matrix on a uniform n-point line: tridiag(h/6, 2h/3, h/6)
    with boundary diagonal h/3."""
    M = np.zeros((n, n))
    i = np.arange(n - 1)
    M[i, i + 1] = h / 6.0
    M[i + 1, i] = h / 6.0
    d = np.full(n, 2.0 * h / 3.0)
    d[0] = d[-1] = h / 3.0
    M[np.arange(n), np.arange(n)] = d
    return M


def lattice_mass_inverse(space, squared: bool = False, scale: float = 1.0, *,
                         device="cuda", dtype=torch.float64) -> LinOp | None:
    """Exact W⁻¹ = scale·M⁻¹ (or scale²·M⁻²) for the mass matrix of a
    uniform tensor-product Q1 lattice, at any size.

    On such a grid the assembled mass matrix factors exactly as
    M = M₁ ⊗ M₁ (⊗ M₁ in 3D); each 1D factor is inverted once on the host in
    float64.  The 1D inverse decays like (2-√3)^|i-j| ≈ 0.268^|i-j|, so its
    diagonals below 1e-15 of its largest entry are dropped: a band of 26
    (28 for M⁻²) at 513 points, exact to machine precision in float32 and
    float64.  Along each axis the apply takes every shifted copy of the
    zero-padded lattice tensor as one strided view, multiplies it by the
    kept diagonals and sums over them: three kernels an axis, no matmul.

    Returns ``None`` when ``space`` is not an eligible lattice.  The apply
    takes flat ``(n,)`` vectors, lattice tensors or ``(n, k)`` stacks."""
    if (space is None or not getattr(space, "continuous", False)
            or space.fe.degree != 1 or not hasattr(space, "n_points_1d")):
        return None
    npts = tuple(int(x) for x in space.n_points_1d)    # coordinate order
    hs = tuple(float(x) for x in space.grid.h)
    bands = []
    for n, h in zip(reversed(npts), reversed(hs)):     # lattice axis order
        inv = np.linalg.inv(_lattice_1d_mass(n, h))
        if squared:
            inv = inv @ inv
        tol = 1e-15 * np.abs(inv).max()
        b = 0
        for k in range(1, n):
            if np.abs(np.diagonal(inv, k)).max() <= tol:
                break
            b = k
        # coefficient planes per offset: W[k+b, i] = inv[i, i+k]
        W = np.zeros((2 * b + 1, n))
        for k in range(-b, b + 1):
            dg = np.diagonal(inv, k)
            W[k + b, max(0, -k):max(0, -k) + len(dg)] = dg
        bands.append((b, torch.as_tensor(W, dtype=dtype, device=device)))
    lat_shape = tuple(reversed(npts))
    total = int(np.prod(npts))
    s = scale * scale if squared else scale

    def mv(x):
        trail = tuple(x.shape[1:]) if x.shape[0] == total else ()
        u = x.reshape(lat_shape + trail)
        for ax, (b, W) in enumerate(bands):
            n = lat_shape[ax]
            # F.pad lists (before, after) from the last axis backwards
            pads = [0, 0] * (u.dim() - 1 - ax) + [b, b]
            # every shifted copy along ax as one strided view: axis ax
            # becomes the 2b+1 offsets, the n outputs go last
            win = torch.nn.functional.pad(u, pads).unfold(ax, n, 1)
            wsh = [1] * win.dim()
            wsh[ax], wsh[-1] = 2 * b + 1, n
            u = (W.to(x.dtype).reshape(wsh) * win).sum(dim=ax).movedim(-1, ax)
        return (s * u).reshape(x.shape)

    return LinOp(mv, (total, total), mv,
                 name="M^-2(lat)" if squared else "M^-1(lat)")


def _dense_inv(M) -> np.ndarray:
    return np.linalg.inv(M.to_dense())


def inv_exact(M, tol: float = 0.0, reduction: float = 1e-14,
              max_steps: int = 1000, scale: float = 1.0,
              space=None) -> LinOp:
    """W = M/scale solved exactly (UMFPACK M⁻¹ stand-in,
    immersed_laplace.cc:849-878): the tensor-product inverse when ``space``
    is a uniform Q1 lattice (:func:`lattice_mass_inverse`), a dense inverse
    (one matmul an apply) up to :data:`DENSE_INV_MAX` dofs, Jacobi-CG to
    ``reduction`` above.  ``scale`` gives the h-scaled variant W = M/h² ->
    W⁻¹ = h²·M⁻¹.  The dense path is exact and ignores the CG controls.
    ``M`` is a :class:`~..ops.operators.CellMatrix`; the inverse lives on
    its device and in its dtype."""
    dev, dt = M.device, M.dtype
    lat = lattice_mass_inverse(space, squared=False, scale=scale,
                               device=dev, dtype=dt)
    if lat is not None:
        return lat
    if M.shape[0] <= DENSE_INV_MAX:
        inv = torch.as_tensor(scale * _dense_inv(M), dtype=dt, device=dev)

        def mv(x):
            return inv.to(x.dtype) @ x

        return LinOp(mv, M.shape, mv, name="M^-1")
    dinv = 1.0 / M.diag()

    def mv(x):
        # float32 floor: a 1e-14 reduction is out of reach in single
        # precision, and the nested CG would run max_steps on every W⁻¹
        # apply; Jacobi-CG on a mass matrix reaches the float32 floor in
        # about 30 steps
        red = reduction
        if x.dtype == torch.float32:
            red = max(reduction, 2e-7)
        y, _ = cg(M.mv, x, M=lambda r: dinv.to(r.dtype) * r, tol=tol,
                  reduction=red, max_steps=max_steps)
        return scale * y

    return LinOp(mv, M.shape, mv, name="M^-1")


def inv_squared_exact(M, space=None, **kw) -> LinOp:
    """W = M²: the exact inverse applied twice (immersed_laplace.cc:875-878).
    Uniform Q1 lattices use the tensor-product M⁻² at any size
    (:func:`lattice_mass_inverse`); small matrices fold both applications
    into one precomputed (M⁻¹)² matmul."""
    scale = kw.get("scale", 1.0)
    lat = lattice_mass_inverse(space, squared=True, scale=scale,
                               device=M.device, dtype=M.dtype)
    if lat is not None:
        return lat
    if M.shape[0] <= DENSE_INV_MAX:
        inv = _dense_inv(M)
        inv2 = torch.as_tensor(scale * scale * (inv @ inv), dtype=M.dtype,
                               device=M.device)

        def mv(x):
            return inv2.to(x.dtype) @ x

        return LinOp(mv, M.shape, mv, name="M^-2")
    inv = inv_exact(M, **kw)
    return inv @ inv


def inv_diag_of_m_squared(M) -> LinOp:
    """W = diag(M·M): row-wise Σ_j M_ij² of the assembled matrix (the
    reference's ``compute_inverse_diagonal_mass_squared``,
    utilities.h:348-374), from deduplicated COO on the host."""
    return diag_op(torch.as_tensor(1.0 / diag_of_m_squared(M),
                                   dtype=M.dtype, device=M.device))


def diag_of_m_squared(M) -> np.ndarray:
    """diag(M·M) of a :class:`~..ops.operators.CellMatrix`, float64 NumPy."""
    rows, cols, vals = M.to_coo()
    ncols = M.shape[1]
    key = rows.astype(np.int64) * ncols + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_s, vals_s = key[order], vals[order]
    boundaries = np.flatnonzero(np.diff(key_s)) + 1
    seg_vals = np.add.reduceat(vals_s, np.concatenate([[0], boundaries]))
    seg_rows = (key_s[np.concatenate([[0], boundaries])]
                // ncols).astype(np.int64)
    diag_m2 = np.zeros(M.shape[0])
    np.add.at(diag_m2, seg_rows, seg_vals ** 2)
    return diag_m2
