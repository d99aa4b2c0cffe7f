"""The AL block preconditioner, the inverse weights, Chebyshev smoothing and
the lattice GMG V-cycle."""

from .al import al_preconditioner
from .weights import inv_diag
from .chebyshev import chebyshev
from .gmg import GMG, FusedSmoother, LatticeTransfer2D, build_gmg

__all__ = ["al_preconditioner", "inv_diag", "chebyshev", "GMG",
           "FusedSmoother", "LatticeTransfer2D", "build_gmg"]
