"""Setup state carried from the reference package into a port problem.

This system has no weights: what a parity run carries across is the setup
state of one problem (right-hand sides, Dirichlet data, the coupling table,
the immersed mass diagonal or the whole immersed mass and stiffness matrices,
and the GMG Lanczos start vectors), handed over as NumPy arrays so both
solvers run on identical inputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.coupling import Coupling
from ..ops.operators import CellMatrix

__all__ = ["CarriedState", "DiagonalMatrix", "state_from_jax"]


class DiagonalMatrix:
    """Stands in for the immersed mass matrix where only its assembled
    diagonal is carried (W = diag(M))."""

    def __init__(self, d: torch.Tensor):
        self._d = d

    def diag(self) -> torch.Tensor:
        return self._d


@dataclass
class CarriedState:
    rhs_f: torch.Tensor
    rhs_g: torch.Tensor
    bc_values: torch.Tensor
    free: torch.Tensor
    coupling: Coupling
    mass: DiagonalMatrix | CellMatrix
    stiffness: CellMatrix | None
    lanczos_starts: list | None


_KEYS = ("rhs_f", "rhs_g", "bc_values", "free", "bg_dofs", "bg_phi",
         "imm_dofs", "imm_psi", "jxw", "m_diag")


def state_from_jax(arrays: dict, device, dtype) -> CarriedState:
    """Load a reference problem's setup arrays (NumPy) for
    :meth:`..models.immersed_laplace.ImmersedLaplaceProblem.load_state`.

    ``arrays`` holds ``rhs_f``, ``rhs_g``, ``bc_values``, ``free``, the
    coupling table ``bg_dofs``, ``bg_phi``, ``imm_dofs``, ``imm_psi``,
    ``jxw``, the immersed mass diagonal ``m_diag`` and optionally
    ``lanczos_starts``, a list of per-level Lanczos start vectors (fine level
    first; the augmented operator's GMG and ``K⁻¹``'s have the same levels
    and the reference draws the same vector for both).  Each vector keeps
    its own dtype: the reference draws them in the Lanczos precision, float64
    for a float64 hierarchy and float32 for a bfloat16 one
    (``gmg.py:376-393``), and the port's Lanczos in that precision then
    starts from the same values.  With
    ``imm_cell_dofs``, ``m_local`` and ``a_local`` (per-cell local matrices)
    the whole immersed mass and stiffness matrices are carried, as the
    rational mode needs them."""
    missing = [k for k in _KEYS if k not in arrays]
    if missing:
        raise KeyError(f"state_from_jax: missing arrays {missing}")

    def ten(key, dt=dtype):
        return torch.as_tensor(np.array(arrays[key]), dtype=dt,
                               device=device)

    rhs_f, rhs_g = ten("rhs_f"), ten("rhs_g")
    coupling = Coupling(arrays["bg_dofs"], arrays["bg_phi"],
                        arrays["imm_dofs"], arrays["imm_psi"], arrays["jxw"],
                        (rhs_g.shape[0], rhs_f.shape[0]), device=device,
                        dtype=dtype)
    starts = arrays.get("lanczos_starts")
    mass, stiffness = DiagonalMatrix(ten("m_diag")), None
    if "m_local" in arrays:
        dofs, n = arrays["imm_cell_dofs"], rhs_g.shape[0]

        def cell_matrix(key):
            return CellMatrix(dofs, dofs, np.asarray(arrays[key]), (n, n),
                              device=device, dtype=dtype)

        mass, stiffness = cell_matrix("m_local"), cell_matrix("a_local")
    return CarriedState(
        rhs_f=rhs_f, rhs_g=rhs_g, bc_values=ten("bc_values"),
        free=ten("free", torch.bool), coupling=coupling,
        mass=mass, stiffness=stiffness,
        lanczos_starts=None if starts is None
        else [np.array(v) for v in starts])
