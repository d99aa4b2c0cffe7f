"""Problem models: setup and solve of one configured problem."""

from .immersed_laplace import ImmersedLaplaceConfig, ImmersedLaplaceProblem

__all__ = ["ImmersedLaplaceConfig", "ImmersedLaplaceProblem"]
