"""The augmented-Lagrangian block preconditioner of 2x2 DLM systems.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.precond.al``
(reference ``augmented_lagrangian_preconditioner.h`` C1, lines 14-42); the
other four variants wait for the families that use them.
"""

from __future__ import annotations

from ..ops.blocks import BlockLayout

__all__ = ["al_preconditioner"]


def al_preconditioner(layout: BlockLayout, aug_inv, Ct, inv_w, gamma):
    """2x2 AL right-preconditioner:

        v1 = -γ·W⁻¹ u1
        v0 = Aug⁻¹ (u0 - Cᵀ v1)
    """

    def apply(u):
        u0, u1 = layout.split(u)
        v1 = -gamma * inv_w(u1)
        v0 = aug_inv(u0 - Ct(v1))
        return layout.concat((v0, v1))

    return apply
