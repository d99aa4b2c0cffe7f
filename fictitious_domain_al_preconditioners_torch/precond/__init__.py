"""The AL block preconditioners, the inverse weights, Chebyshev smoothing and
the GMG V-cycle (the lattice hierarchy and the flat, vector one)."""

from .al import (al_preconditioner, al_preconditioner_diagonal,
                 al_preconditioner_ideal, al_preconditioner_modified,
                 al_preconditioner_stokes)
from .weights import (inv_diag, inv_diag_squared, inv_diag_of_m_squared,
                      inv_exact, inv_squared_exact, lattice_mass_inverse)
from .chebyshev import chebyshev
from .gmg import (GMG, FusedSmoother, LatticeTransfer2D, Prolongation,
                  VectorProlongation, build_gmg, build_gmg_flat,
                  make_prolongation)

__all__ = ["al_preconditioner", "al_preconditioner_ideal",
           "al_preconditioner_modified", "al_preconditioner_stokes",
           "al_preconditioner_diagonal", "inv_diag", "inv_diag_squared",
           "inv_diag_of_m_squared", "inv_exact", "inv_squared_exact",
           "lattice_mass_inverse", "chebyshev", "GMG", "FusedSmoother",
           "LatticeTransfer2D", "Prolongation", "VectorProlongation",
           "make_prolongation", "build_gmg", "build_gmg_flat"]
