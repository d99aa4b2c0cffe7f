"""Rational (fractional-Laplacian) preconditioner  P = diag(K⁻¹, (−Δ_Γ)^{-1/2}).

Counterpart of ``fictitious_domain_al_preconditioners_tpu.precond.rational``
(the reference's ``RationalPreconditioner``, rational_preconditioner.h:12-99).
The multiplier block applies a rational approximation of the positive
fractional power (λ/ρ)^{+1/2} of the pencil (A_Γ, M_Γ),

    v₁ = d₀·M⁻¹u₁ + ρ Σᵢ dᵢ (A_Γ − ρ pᵢ M)⁻¹ u₁ ,   r(x)=d₀+Σdᵢ/(x-pᵢ) ≈ √x,

with ρ an upper spectral bound of M⁻¹A_Γ (immersed_laplace.cc:609-614).  The
pole/residue table is computed at setup by the AAA algorithm on the host
(NumPy/SciPy); all shifted SPD systems are solved by one batched CG
(:func:`..ops.krylov.batched_cg`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.blocks import BlockLayout
from ..ops.krylov import batched_cg, cg
from ..ops.operators import CellMatrix

__all__ = ["aaa", "rational_sqrt", "rational_x_inv_sqrt",
           "rational_preconditioner"]


def aaa(F, Z, tol: float = 1e-11, mmax: int = 40):
    """Minimal AAA rational approximation: returns (poles, residues, d0) of

        r(z) = d0 + Σ_i residues_i / (z - poles_i)  ≈  F on the sample set Z.

    Classic barycentric AAA with greedy support-point selection."""
    from scipy.linalg import eig

    Z = np.asarray(Z, dtype=float)
    F = np.asarray(F, dtype=float)
    mask = np.ones(len(Z), dtype=bool)  # remaining sample points
    zj, fj, w = [], [], None
    R = np.full(len(Z), F.mean())
    for _ in range(mmax):
        j = int(np.argmax(np.abs(F - R) * mask))    # greedy: largest residual
        zj.append(Z[j])
        fj.append(F[j])
        mask[j] = False
        zs, fs = np.array(zj), np.array(fj)
        C = 1.0 / (Z[mask, None] - zs[None, :])     # Cauchy matrix
        A = (F[mask, None] - fs[None, :]) * C       # Loewner matrix
        w = np.linalg.svd(A, full_matrices=False)[2][-1]
        R = F.copy()
        R[mask] = (C @ (w * fs)) / (C @ w)
        if np.max(np.abs(F - R)) <= tol * np.max(np.abs(F)):
            break
    zs, fs = np.array(zj), np.array(fj)
    m = len(w)
    # poles: generalized eigenvalues of the arrowhead pencil
    E = np.zeros((m + 1, m + 1))
    E[0, 1:] = w
    E[1:, 0] = 1.0
    E[1:, 1:] = np.diag(zs)
    B = np.eye(m + 1)
    B[0, 0] = 0.0
    ev = eig(E, B, right=False)
    ev = ev[np.isfinite(ev)]
    poles = np.real(ev[np.abs(np.imag(ev))
                       <= 1e-8 * np.maximum(1.0, np.abs(ev))])

    def num(z):
        return np.sum(w * fs / (z - zs))

    def dden(z):
        return -np.sum(w / (z - zs) ** 2)

    residues = np.array([num(p) / dden(p) for p in poles])
    d0 = float(np.sum(w * fs) / np.sum(w))  # r(inf)
    return poles, residues, d0


def rational_sqrt(lower: float = 1e-5, n_samples: int = 600,
                  tol: float = 1e-10, mmax: int = 30):
    """Poles/residues/constant of r(x) ≈ x^{+1/2} on [lower, 1] (log-spaced
    samples); the poles kept are the negative real ones."""
    Z = np.geomspace(lower, 1.0, n_samples)
    poles, residues, d0 = aaa(np.sqrt(Z), Z, tol=tol, mmax=mmax)
    keep = poles < 0
    return poles[keep], residues[keep], d0


def rational_x_inv_sqrt(lower: float = 1e-7, **kw):
    """Rational approximation of x^{-1/2} on [lower, 1] (for spectral
    experiments; the preconditioner uses :func:`rational_sqrt`)."""
    Z = np.geomspace(lower, 1.0, kw.pop("n_samples", 600))
    poles, residues, d0 = aaa(1.0 / np.sqrt(Z), Z, tol=kw.pop("tol", 1e-10),
                              mmax=kw.pop("mmax", 30))
    keep = poles < 0
    return poles[keep], residues[keep], d0


def rational_preconditioner(layout: BlockLayout, K_inv, A_imm: CellMatrix,
                            M_imm: CellMatrix, rho_bound: float, *,
                            lower: float = 1e-5, cg_tol: float = 1e-12,
                            cg_max_steps: int = 2000,
                            stats: dict | None = None):
    """The block-diagonal rational preconditioner apply (the reference's
    vmult, rational_preconditioner.h:41-62):
    v₀ = K⁻¹u₀, v₁ = d₀M⁻¹u₁ + Σ ρdᵢ(A−ρpᵢM)⁻¹u₁.

    The stopping levels of the pole and mass solves follow the tensors'
    dtype: float32 cannot reach the float64 levels, so they are clamped.
    (The JAX package's ``block_scale`` and ``const_fix`` calibrations, off
    by default and used by no solver there, are not ported.)"""
    poles, residues, d0 = rational_sqrt(lower=lower)
    k = len(poles)
    dev, dt = M_imm.local.device, M_imm.local.dtype
    shifts = torch.as_tensor(-rho_bound * poles, dtype=dt, device=dev)
    coeffs = torch.as_tensor(residues * rho_bound, dtype=dt, device=dev)
    m_diag, a_diag = M_imm.diag(), A_imm.diag()
    md_inv = 1.0 / m_diag
    dinv_batch = 1.0 / (a_diag[:, None] + m_diag[:, None] * shifts[None, :])

    if dt == torch.float32:
        cg_tol = max(cg_tol, 1e-7)
        cg_red, m_red = 1e-6, 1e-6
    else:
        cg_red, m_red = 1e-12, 1e-14

    # Pencil zero-mode deflation (closed Γ: A_Γ·1 = 0).  r(0) is a ~4-digit
    # cancellation of the pole terms and the smallest shifts make the pole
    # systems nearly singular on the constant mode, so float32 loses it.
    # Split u₁ = c·M1 + u₁⊥, solve the poles on u₁⊥ only and add the exact
    # action r(0)·c·1 back (a no-op in float64).
    a_rows, _, a_vals = A_imm.to_coo()
    a_rowsum = np.zeros(A_imm.shape[0])
    np.add.at(a_rowsum, a_rows, a_vals)
    a_scale = np.abs(a_vals).max() if len(a_vals) else 1.0
    deflate = bool(np.abs(a_rowsum).max() <= 1e-8 * a_scale)
    if deflate:
        m_rows, _, m_vals = M_imm.to_coo()
        m_one_h = np.zeros(M_imm.shape[0])
        np.add.at(m_one_h, m_rows, m_vals)           # M·1 (float64 host)
        m_total = float(m_one_h.sum())               # 1ᵀM1 = |Γ|
        r0 = float(d0 - np.sum(residues / poles))    # r(0), exact in f64
        m_one = torch.as_tensor(m_one_h, dtype=dt, device=dev)

    def batched_A(X):
        return A_imm.mv(X) + M_imm.mv(X) * shifts[None, :]

    def m_inv(v):
        x, _ = cg(M_imm.mv, v, M=lambda r: md_inv * r, tol=0.0,
                  reduction=m_red, max_steps=cg_max_steps, stats=stats)
        return x

    def apply(u):
        u0, u1 = layout.split(u)
        v0 = K_inv(u0)
        if deflate:
            c = torch.sum(u1) / m_total
            u1p = u1 - c * m_one
        else:
            u1p = u1
        B = u1p[:, None].expand(u1p.shape[0], k)
        X, _ = batched_cg(batched_A, B, M=lambda R: dinv_batch * R,
                          tol=cg_tol, reduction=cg_red,
                          max_steps=cg_max_steps, stats=stats)
        v1 = d0 * m_inv(u1p) + X @ coeffs
        if deflate:
            v1 = v1 + r0 * c
        return layout.concat((v0, v1))

    return apply
