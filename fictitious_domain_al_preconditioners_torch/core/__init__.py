"""Host-side NumPy setup: quadrature, finite elements, the background grid and
the immersed curve.

These modules are verbatim copies of ``fictitious_domain_al_preconditioners_tpu.core``
(they are pure NumPy there too).  They are copied, not imported, because
importing anything under the JAX package runs its ``__init__``, which imports
jax."""

from .quadrature import gauss, GaussRule
from .fe import FE, DGPElement
from .grid import UniformGrid, GridSpace
from .immersed import ImmersedMesh, ImmersedSpace, parametrized_curve

__all__ = ["gauss", "GaussRule", "FE", "DGPElement", "UniformGrid",
           "GridSpace", "ImmersedMesh", "ImmersedSpace", "parametrized_curve"]
