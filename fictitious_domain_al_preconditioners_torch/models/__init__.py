"""Problem models: setup and solve of one configured problem."""

from .immersed_laplace import ImmersedLaplaceConfig, ImmersedLaplaceProblem
from .elliptic_interface import (EllipticInterfaceConfig,
                                 EllipticInterfaceProblem)
from .stokes import StokesConfig, StokesProblem

__all__ = ["ImmersedLaplaceConfig", "ImmersedLaplaceProblem",
           "EllipticInterfaceConfig", "EllipticInterfaceProblem",
           "StokesConfig", "StokesProblem"]
