"""Structured-lattice background operators and Q1 grid transfers."""

from .lattice import (LatticeOps, to_flat, flat_to_lattice, lattice_prolong,
                      lattice_restrict)

__all__ = ["LatticeOps", "to_flat", "flat_to_lattice", "lattice_prolong",
           "lattice_restrict"]
