"""Inverse-weight (W⁻¹) operators for the AL term γ·CᵀW⁻¹C.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.precond.weights``;
the flagship path uses W = diag(M) only.
"""

from __future__ import annotations

from ..ops.linop import LinOp, diag_op

__all__ = ["inv_diag"]


def inv_diag(M) -> LinOp:
    """W = diag(M) (operator-form immersed_laplace, lines 856-863).  ``M`` is
    anything with ``diag()``, e.g. an ``ops.operators.CellMatrix``."""
    return diag_op(1.0 / M.diag())
