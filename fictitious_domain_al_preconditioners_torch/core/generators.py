"""Grid generation by name + arguments.

Copy of ``fictitious_domain_al_preconditioners_tpu.core.generators`` (pure
NumPy there too), the analog of deal.II
``GridGenerator::generate_from_name_and_arguments`` (used by
elliptic_interface.cc:466-480 and nitsche_bcs.cc:251): the grid kind and its
arguments are *config data*.  Backgrounds map to implicit uniform grids;
immersed domains map to explicit immersed meshes.

Argument syntax matches deal.II: colon-separated positional arguments,
points as comma-separated coordinates (e.g. ``"-1: 1: true"`` for
``hyper_cube(left, right, colorize)``).
"""

from __future__ import annotations

import numpy as np

from .grid import UniformGrid
from .immersed import (ImmersedMesh, hyper_ball, hyper_sphere,
                       immersed_uniform_grid)

__all__ = ["background_grid_from_name", "immersed_mesh_from_name"]


def _split_args(arguments: str):
    return [a.strip() for a in arguments.split(":") if a.strip() != ""]


def _parse_point(s: str) -> np.ndarray:
    return np.array([float(p) for p in s.split(",")])


def background_grid_from_name(name: str, arguments: str, dim: int,
                              refinement: int = 0) -> UniformGrid:
    """Background grids are restricted to box domains (every reference config
    uses hyper_cube/hyper_rectangle backgrounds)."""
    args = _split_args(arguments)
    if name == "hyper_cube":
        left = float(args[0]) if args else 0.0
        right = float(args[1]) if len(args) > 1 else 1.0
        return UniformGrid.hyper_cube(dim, left, right, refinement)
    if name == "hyper_rectangle":
        p1 = _parse_point(args[0])
        p2 = _parse_point(args[1])
        return UniformGrid.hyper_rectangle(p1, p2, refinement)
    raise ValueError(f"unsupported background grid generator {name!r} "
                     "(backgrounds are implicit uniform boxes)")


def immersed_mesh_from_name(name: str, arguments: str, dim: int,
                            refinement: int = 0) -> ImmersedMesh:
    args = _split_args(arguments)
    if name in ("hyper_cube", "hyper_rectangle"):
        grid = background_grid_from_name(name, arguments, dim, refinement)
        return immersed_uniform_grid(grid)
    if name == "hyper_ball":
        center = _parse_point(args[0]) if args else np.zeros(dim)
        radius = float(args[1]) if len(args) > 1 else 1.0
        assert dim == 2, "hyper_ball immersed mesh implemented for 2D"
        return hyper_ball(center, radius, refinement)
    if name == "hyper_sphere":
        center = _parse_point(args[0]) if args else np.zeros(3)
        radius = float(args[1]) if len(args) > 1 else 1.0
        return hyper_sphere(center, radius, refinement)
    raise ValueError(f"unsupported immersed grid generator {name!r}")
