"""Gauss-Legendre quadrature on the reference cube ``[0,1]^dim``.

TPU-native replacement for deal.II ``QGauss<dim>`` (used throughout the
reference, e.g. immersed_laplace.cc "Coupling quadrature order").  Everything
here is setup-time NumPy; rules become static constants baked into jitted
assembly kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["gauss_rule_1d", "GaussRule", "gauss"]


def gauss_rule_1d(n: int):
    """n-point Gauss-Legendre rule on [0, 1] (exact for degree 2n-1)."""
    pts, wts = np.polynomial.legendre.leggauss(n)
    return (pts + 1.0) / 2.0, wts / 2.0


@dataclass(frozen=True)
class GaussRule:
    """Tensor-product Gauss rule: ``points`` (nq, dim), ``weights`` (nq,)."""

    dim: int
    order: int  # points per direction (deal.II QGauss<dim>(order))
    points: np.ndarray
    weights: np.ndarray

    @property
    def n_points(self) -> int:
        return self.points.shape[0]


def gauss(dim: int, order: int) -> GaussRule:
    p1, w1 = gauss_rule_1d(order)
    if dim == 0:
        return GaussRule(0, order, np.zeros((1, 0)), np.ones((1,)))
    # lexicographic: first axis fastest (matches local dof ordering in fe.py)
    grids = np.meshgrid(*([p1] * dim), indexing="ij")
    wgrids = np.meshgrid(*([w1] * dim), indexing="ij")
    pts = np.stack([g.reshape(-1, order="F") for g in grids], axis=-1)
    wts = np.ones(pts.shape[0])
    for g in wgrids:
        wts = wts * g.reshape(-1, order="F")
    return GaussRule(dim, order, pts, wts)
