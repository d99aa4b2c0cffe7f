"""Chebyshev polynomial smoother (deal.II ``PreconditionChebyshev`` analog).

Counterpart of ``fictitious_domain_al_preconditioners_tpu.precond.chebyshev``.
"""

from __future__ import annotations

__all__ = ["chebyshev"]


def chebyshev(A, diag_inv, lam_max: float, degree: int = 4,
              eig_ratio: float = 30.0, lam_max_safety: float = 1.1):
    """Chebyshev iteration for D⁻¹A with spectrum bounded by ``lam_max``
    (Lanczos estimate), targeting ``[lam_max/eig_ratio, lam_max*safety]``.

    Returns ``b -> x ≈ A⁻¹ b`` (x0 = 0)."""
    lmax = lam_max * lam_max_safety
    lmin = lam_max / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta

    def apply(b):
        x = (diag_inv * b) / theta
        rho = 1.0 / sigma1
        p = x
        for _ in range(degree - 1):
            r = b - A(x)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            p = (rho_new * rho) * p + (2.0 * rho_new / delta) * (diag_inv * r)
            x = x + p
            rho = rho_new
        return x

    return apply
