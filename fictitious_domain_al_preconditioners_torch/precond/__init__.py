"""The AL block preconditioner, the inverse weights, Chebyshev smoothing and
the lattice GMG V-cycle."""

from .al import (al_preconditioner, al_preconditioner_ideal,
                 al_preconditioner_modified)
from .weights import (inv_diag, inv_diag_squared, inv_diag_of_m_squared,
                      inv_exact, inv_squared_exact, lattice_mass_inverse)
from .chebyshev import chebyshev
from .gmg import GMG, FusedSmoother, LatticeTransfer2D, build_gmg

__all__ = ["al_preconditioner", "al_preconditioner_ideal",
           "al_preconditioner_modified", "inv_diag", "inv_diag_squared",
           "inv_diag_of_m_squared", "inv_exact", "inv_squared_exact",
           "lattice_mass_inverse", "chebyshev", "GMG",
           "FusedSmoother", "LatticeTransfer2D", "build_gmg"]
