"""The augmented-Lagrangian block preconditioners.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.precond.al``
(reference ``augmented_lagrangian_preconditioner.h``):

  - :func:`al_preconditioner`           (C1, lines 14-42, 2x2 DLM systems)
  - :func:`al_preconditioner_stokes`    (C2, lines 44-79, 3x3 (u, p, λ))
  - :func:`al_preconditioner_diagonal`  (C3, lines 81-110, SPD for MinRes)
  - :func:`al_preconditioner_ideal`     (C4, lines 115-164, elliptic ideal)
  - :func:`al_preconditioner_modified`  (C5, lines 168-238, modified AL)

Each application is an ``al.apply`` span (:mod:`..tracer`) whose ``form``
names the function; :func:`block_solve` is the models' inner CG on a
block (``Aug⁻¹``, A11⁻¹, A22⁻¹).
"""

from __future__ import annotations

from ..ops.blocks import BlockLayout
from ..ops.krylov import cg
from ..tracer import span

__all__ = ["block_solve", "al_preconditioner", "al_preconditioner_stokes",
           "al_preconditioner_diagonal", "al_preconditioner_ideal",
           "al_preconditioner_modified"]


def block_solve(A, b, *, stats: dict, **kw):
    """CG on one block of an AL preconditioner (``kw``: ``M``, the block's
    V-cycle, and the controls), as an ``al.block_solve`` span; its
    iterations are added to ``stats["inner_iterations"]``.  Returns
    ``(x, SolveInfo)``."""
    with span("al.block_solve"):
        x, info = cg(A, b, stats=stats, **kw)
    stats["inner_iterations"] = (stats.get("inner_iterations", 0)
                                 + info.iterations)
    return x, info


def al_preconditioner(layout: BlockLayout, aug_inv, Ct, inv_w, gamma):
    """2x2 AL right-preconditioner:

        v1 = -γ·W⁻¹ u1
        v0 = Aug⁻¹ (u0 - Cᵀ v1)
    """

    def apply(u):
        with span("al.apply", form="dlm"):
            u0, u1 = layout.split(u)
            v1 = -gamma * inv_w(u1)
            v0 = aug_inv(u0 - Ct(v1))
            return layout.concat((v0, v1))

    return apply


def al_preconditioner_stokes(layout: BlockLayout, aug_inv, Bt, Ct, inv_w,
                             mp_inv, gamma, gamma_grad_div):
    """3x3 Stokes AL preconditioner over (u, p, λ) (reference C2, lines
    62-70):

        v2 = -γ·W⁻¹ u2
        v1 = -γ_gd·Mp⁻¹ u1
        v0 = Aug⁻¹ (u0 - Bᵀ v1 - Cᵀ v2)
    """

    def apply(u):
        with span("al.apply", form="stokes"):
            u0, u1, u2 = layout.split(u)
            v2 = -gamma * inv_w(u2)
            v1 = -gamma_grad_div * mp_inv(u1)
            v0 = aug_inv(u0 - Bt(v1) - Ct(v2))
            return layout.concat((v0, v1, v2))

    return apply


def al_preconditioner_diagonal(layout: BlockLayout, aug_inv, inv_w, mp_inv,
                               gamma, gamma_grad_div):
    """SPD block-diagonal variant for MinRes (reference C3, lines 95-103):
    ``diag(Aug⁻¹, γ_gd Mp⁻¹, γ W⁻¹)`` ('Diagonal SPD preconditioner',
    stokes_immersed_boundary.cc:1056-1064)."""

    def apply(u):
        with span("al.apply", form="diagonal"):
            u0, u1, u2 = layout.split(u)
            return layout.concat((aug_inv(u0), gamma_grad_div * mp_inv(u1),
                                  gamma * inv_w(u2)))

    return apply


def al_preconditioner_ideal(layout: BlockLayout, aug_inv_coupled, Ct, M,
                            inv_w, gamma):
    """'Ideal' AL preconditioner of the 3x3 elliptic interface system
    (reference C4, lines 130-156): the (u1, u2) block is inverted coupled,

        v2        = -γ·W⁻¹ u2
        [v0, v1]  = Aug⁻¹ [u0 - Cᵀ v2,  u1 + M v2]

    ``aug_inv_coupled`` acts on the concatenated (u0, u1) sub-block."""
    sub = BlockLayout(layout.sizes[:2])

    def apply(u):
        with span("al.apply", form="ideal"):
            u0, u1, u2 = layout.split(u)
            v2 = -gamma * inv_w(u2)
            v0, v1 = sub.split(aug_inv_coupled(
                sub.concat((u0 - Ct(v2), u1 + M(v2)))))
            return layout.concat((v0, v1, v2))

    return apply


def al_preconditioner_modified(layout: BlockLayout, A11_inv, A22_inv, Ct, M,
                               inv_w, gamma):
    """Modified AL preconditioner, the paper's block-triangular variant
    (reference C5, lines 225-228):

        v2 = -γ·W⁻¹ λ
        v1 = A22⁻¹ (u2 + M v2)
        v0 = A11⁻¹ (u + γ·Cᵀ W⁻¹ M v1 - Cᵀ v2)
    """

    def apply(u):
        with span("al.apply", form="modified"):
            u0, u1, u2 = layout.split(u)
            v2 = -gamma * inv_w(u2)
            v1 = A22_inv(u1 + M(v2))
            v0 = A11_inv(u0 + gamma * Ct(inv_w(M(v1))) - Ct(v2))
            return layout.concat((v0, v1, v2))

    return apply
