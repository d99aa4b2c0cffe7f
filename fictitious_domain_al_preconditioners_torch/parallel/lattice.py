"""Structured-lattice (tensor-product) background operators.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.parallel.lattice``.
A Q1 field on the uniform background grid is a dense lattice tensor; the
stiffness applies as separable 1D three-point operators along each axis
(K = K₁⊗M₁ + M₁⊗K₁) and the Q1 grid transfers are interleaves.

Layout: lattice axis order is REVERSED relative to the dof index (axis 0 =
slowest coordinate), so a flat dof vector (first coordinate fastest) and its
(ny, nx) lattice are views of one contiguous buffer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.grid import GridSpace
from ..ops.kernels import laplace_stencil_2d

__all__ = ["LatticeOps", "to_flat", "flat_to_lattice", "lattice_prolong",
           "lattice_restrict"]


def _shift(v, s):
    """Shift along axis 0 with zero fill: ``_shift(v, +1)[i] = v[i-1]``."""
    pad = torch.zeros_like(v[:1])
    if s == 1:
        return torch.cat([pad, v[:-1]], dim=0)
    return torch.cat([v[1:], pad], dim=0)


@dataclass(frozen=True)
class LatticeOps:
    """Separable stiffness apply for a Q1 GridSpace; ``shape``/``h`` are in
    lattice axis order (reversed coordinates)."""

    h: tuple
    shape: tuple

    @classmethod
    def for_space(cls, space: GridSpace) -> "LatticeOps":
        if not (space.fe.degree == 1 and space.continuous):
            raise ValueError("lattice operators are Q1-continuous only")
        return cls(tuple(float(x) for x in reversed(space.grid.h)),
                   tuple(int(n) for n in reversed(space.n_points_1d)))

    def _axis_apply_n(self, u, axis, off, diag, bdiag):
        n = self.shape[axis]
        v = torch.movedim(u, axis, 0)
        out = diag * v + off * (_shift(v, 1) + _shift(v, -1))
        corr = diag - bdiag
        out[0] = out[0] + (-corr * v[0])
        out[n - 1] = out[n - 1] + (-corr * v[n - 1])
        return torch.movedim(out, 0, axis)

    def _mass_axis(self, u, axis):
        h = self.h[axis]
        return self._axis_apply_n(u, axis, h / 6.0, 2.0 * h / 3.0, h / 3.0)

    def _stiff_axis(self, u, axis):
        h = self.h[axis]
        return self._axis_apply_n(u, axis, -1.0 / h, 2.0 / h, 1.0 / h)

    def laplace(self, u):
        """Unconstrained Q1 stiffness apply on a lattice tensor.  A 2D CUDA
        tensor goes through kernel K6 (``ops.kernels.laplace_stencil_2d``,
        the same function); otherwise the separable form below runs."""
        if u.dim() == 2 and u.device.type == "cuda":
            return laplace_stencil_2d(u, self.h)
        dim = len(self.shape)
        out = None
        for d in range(dim):
            term = u
            for ax in range(dim):
                term = (self._stiff_axis(term, ax) if ax == d
                        else self._mass_axis(term, ax))
            out = term if out is None else out + term
        return out

    def laplace_diag(self) -> np.ndarray:
        """Assembled stiffness diagonal as NumPy outer sums of the 1D
        operator diagonals, flat (dof order), float64."""
        dim = len(self.shape)
        dK, dM = [], []
        for ax in range(dim):
            h, n = self.h[ax], self.shape[ax]
            k = np.full(n, 2.0 / h)
            k[0] = k[-1] = 1.0 / h
            m = np.full(n, 2.0 * h / 3.0)
            m[0] = m[-1] = h / 3.0
            dK.append(k)
            dM.append(m)
        out = 0.0
        for d in range(dim):
            term = np.array(1.0)
            for ax in range(dim):
                vec = dK[ax] if ax == d else dM[ax]
                term = np.multiply.outer(term, vec)
            out = out + term
        return out.reshape(-1)


def flat_to_lattice(u_flat, shape):
    """``shape`` in dof order (first coordinate fastest) -> lattice view in
    reversed axis order."""
    return u_flat.reshape(tuple(reversed(tuple(shape))))


def to_flat(u_lat):
    return u_lat.reshape(-1)


def _prolong_axis(u, ax):
    """Linear interpolation m -> 2m-1 along ``ax``."""
    v = torch.movedim(u, ax, 0)
    m = v.shape[0]
    out = v.new_empty((2 * m - 1,) + tuple(v.shape[1:]))
    out[0::2] = v
    out[1::2] = 0.5 * (v[:-1] + v[1:])
    return torch.movedim(out, 0, ax)


def _restrict_axis(u, ax):
    """Adjoint of :func:`_prolong_axis`: 2m-1 -> m,
    ``out[i] = f[2i] + 0.5 (f[2i-1] + f[2i+1])`` (zero beyond the ends)."""
    v = torch.movedim(u, ax, 0)
    even = v[0::2]
    odd = v[1::2]
    z = torch.zeros_like(odd[:1])
    odd_lo = torch.cat([z, odd], dim=0)
    odd_hi = torch.cat([odd, z], dim=0)
    return torch.movedim(even + 0.5 * (odd_lo + odd_hi), 0, ax)


def lattice_prolong(u_coarse):
    for ax in range(u_coarse.ndim):
        u_coarse = _prolong_axis(u_coarse, ax)
    return u_coarse.contiguous()


def lattice_restrict(u_fine):
    for ax in range(u_fine.ndim):
        u_fine = _restrict_axis(u_fine, ax)
    return u_fine.contiguous()
