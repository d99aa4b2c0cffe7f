"""Host-side NumPy setup: quadrature, finite elements, the background grid,
the immersed curve and meshes, and the grid generators by name.

These modules are verbatim copies of ``fictitious_domain_al_preconditioners_tpu.core``
(they are pure NumPy there too).  They are copied, not imported, because
importing anything under the JAX package runs its ``__init__``, which imports
jax."""

from .quadrature import gauss, GaussRule
from .fe import FE, DGPElement
from .grid import UniformGrid, GridSpace
from .immersed import ImmersedMesh, ImmersedSpace, parametrized_curve
from .generators import background_grid_from_name, immersed_mesh_from_name

__all__ = ["gauss", "GaussRule", "FE", "DGPElement", "UniformGrid",
           "GridSpace", "ImmersedMesh", "ImmersedSpace", "parametrized_curve",
           "background_grid_from_name", "immersed_mesh_from_name"]
