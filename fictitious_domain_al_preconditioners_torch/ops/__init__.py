"""Operators, assembly, Krylov solvers and the lattice kernels."""

from .linop import LinOp, diag_op, identity, zero_op
from .operators import CellMatrix, constrain, dirichlet_rhs
from .assembly import (mass_matrix, laplace_matrix, rhs_vector,
                       imm_mass_matrix, imm_rhs, interpolate, l2_error,
                       h1_error)
from .coupling import Coupling, build_coupling
from .krylov import (SolveInfo, cg, cg_condition_number, fgmres,
                     lanczos_max_eig)
from .blocks import BlockLayout, block_operator
from .host_ref import (HostAugmentedSystem, HostEllipticSystem,
                       HostStokesSystem)
from .sparse import COO, spgemm_ctwc
from .sparse_band import lattice_band_linop
from . import kernels

__all__ = [
    "LinOp", "diag_op", "identity", "zero_op", "CellMatrix", "constrain",
    "dirichlet_rhs", "mass_matrix", "laplace_matrix", "rhs_vector",
    "imm_mass_matrix", "imm_rhs", "interpolate", "l2_error", "h1_error",
    "Coupling", "build_coupling", "SolveInfo", "cg", "cg_condition_number",
    "fgmres", "lanczos_max_eig", "BlockLayout", "block_operator",
    "HostAugmentedSystem", "HostEllipticSystem", "HostStokesSystem", "COO", "spgemm_ctwc",
    "lattice_band_linop", "kernels",
]
