"""Structured-lattice background operators, Q1 grid transfers and the
row-block partition of the lattice over ranks (``mesh``)."""

from .lattice import (LatticeOps, to_lattice, to_flat, flat_to_lattice,
                      lattice_prolong, lattice_restrict)
from .mesh import (Mesh, make_mesh, lattice_sharding, replicated,
                   sharded_al_cg_step, sharded_two_level_step, padded_shape,
                   launch)

__all__ = ["LatticeOps", "to_lattice", "to_flat", "flat_to_lattice",
           "lattice_prolong", "lattice_restrict",
           "Mesh", "make_mesh", "lattice_sharding", "replicated",
           "sharded_al_cg_step", "sharded_two_level_step", "padded_shape",
           "launch"]
