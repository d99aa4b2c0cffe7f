"""Operators, assembly, Krylov solvers and the lattice kernels."""

from .linop import LinOp, diag_op
from .operators import CellMatrix, constrain, dirichlet_rhs
from .assembly import (rhs_vector, imm_mass_matrix, imm_rhs, interpolate,
                       l2_error)
from .coupling import Coupling, build_coupling
from .krylov import SolveInfo, cg, fgmres, lanczos_max_eig
from .blocks import BlockLayout, block_operator
from .host_ref import HostAugmentedSystem
from . import kernels

__all__ = [
    "LinOp", "diag_op", "CellMatrix", "constrain",
    "dirichlet_rhs", "rhs_vector", "imm_mass_matrix", "imm_rhs",
    "interpolate", "l2_error", "Coupling", "build_coupling", "SolveInfo",
    "cg", "fgmres", "lanczos_max_eig", "BlockLayout", "block_operator",
    "HostAugmentedSystem", "kernels",
]
