"""Problem models: setup and solve of one configured problem."""

from .immersed_laplace import ImmersedLaplaceConfig, ImmersedLaplaceProblem
from .elliptic_interface import (EllipticInterfaceConfig,
                                 EllipticInterfaceProblem)
from .stokes import StokesConfig, StokesProblem
from .nitsche_bcs import NitscheConfig, NitscheProblem
from .elasticity import ElasticityInterfaceConfig, ElasticityInterfaceProblem

__all__ = ["ImmersedLaplaceConfig", "ImmersedLaplaceProblem",
           "EllipticInterfaceConfig", "EllipticInterfaceProblem",
           "StokesConfig", "StokesProblem", "NitscheConfig", "NitscheProblem",
           "ElasticityInterfaceConfig", "ElasticityInterfaceProblem"]
