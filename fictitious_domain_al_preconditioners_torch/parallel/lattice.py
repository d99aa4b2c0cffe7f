"""Structured-lattice (tensor-product) background operators.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.parallel.lattice``.
A Q1 field on the uniform background grid is a dense lattice tensor; the
mass and stiffness apply as separable 1D three-point operators along each
axis (M = M₁⊗M₁, K = K₁⊗M₁ + M₁⊗K₁) and the Q1 grid transfers are
interleaves.

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

__all__ = ["LatticeOps", "to_lattice", "to_flat", "flat_to_lattice",
           "lattice_prolong", "lattice_restrict"]


@dataclass(frozen=True)
class LatticeOps:
    """Separable mass and stiffness applies for a Q1 GridSpace;
    ``shape``/``h`` are in lattice axis order (reversed coordinates).
    ``padded`` (optional) is a lattice shape >= ``shape``: :meth:`pad`
    zero-pads a lattice tensor to it and the applies keep the pad region
    zero (``parallel.mesh.padded_shape`` rounds the row count up to the
    ranks)."""

    h: tuple
    shape: tuple
    padded: tuple | None = None

    @classmethod
    def for_space(cls, space: GridSpace,
                  padded: tuple | None = None) -> "LatticeOps":
        """``padded`` is given in dof (coordinate) order and reversed
        here."""
        if not (space.fe.degree == 1 and space.continuous):
            raise ValueError("lattice operators are Q1-continuous only")
        return cls(tuple(float(x) for x in reversed(space.grid.h)),
                   tuple(int(n) for n in reversed(space.n_points_1d)),
                   None if padded is None
                   else tuple(int(n) for n in reversed(padded)))

    @property
    def dof_shape(self) -> tuple:
        return tuple(reversed(self.shape))

    def _mask_pad(self, u):
        if self.padded is None or tuple(self.padded) == tuple(self.shape):
            return u
        out = torch.zeros_like(u)
        sl = tuple(slice(0, n) for n in self.shape)
        out[sl] = u[sl]
        return out

    def pad(self, u_lat):
        """Zero-pad a lattice tensor of ``shape`` to ``padded``."""
        if self.padded is None:
            return u_lat
        out = u_lat.new_zeros(tuple(self.padded) + tuple(u_lat.shape[
            len(self.shape):]))
        out[tuple(slice(0, n) for n in self.shape)] = u_lat
        return out

    def unpad(self, u_lat):
        """The ``shape`` corner of a padded lattice tensor."""
        if self.padded is None:
            return u_lat
        return u_lat[tuple(slice(0, n) for n in self.shape)]

    def _axis_apply_n(self, u, axis, off, diag, bdiag):
        # the boundary rows are the true lattice's, also on a padded tensor
        n = self.shape[axis]
        v = torch.movedim(u, axis, 0)
        out = diag * v
        out[1:].add_(v[:-1], alpha=off)
        out[:-1].add_(v[1:], alpha=off)
        out[0].add_(v[0], alpha=bdiag - diag)
        out[n - 1].add_(v[n - 1], alpha=bdiag - diag)
        return torch.movedim(out, 0, axis)

    def _mass_axis(self, u, axis):
        h = self.h[axis]
        return self._axis_apply_n(u, axis, h / 6.0, 2.0 * h / 3.0, h / 3.0)

    def _stiff_axis(self, u, axis):
        h = self.h[axis]
        return self._axis_apply_n(u, axis, -1.0 / h, 2.0 / h, 1.0 / h)

    def mass(self, u):
        """Q1 mass apply ``M₁ ⊗ M₁`` on a lattice tensor, one 3-point pass
        along each axis."""
        for ax in range(len(self.shape)):
            u = self._mass_axis(u, ax)
        return self._mask_pad(u)

    def laplace(self, u):
        """Unconstrained Q1 stiffness apply on a lattice tensor.  A 2D CUDA
        tensor goes through kernel K6 (``ops.kernels.laplace_stencil_2d``,
        the same function, in float32 or float64); otherwise the separable
        form below runs."""
        if u.dim() == 2 and u.device.type == "cuda":
            # K6 takes the true lattice's edges for its boundary rows
            return self.pad(laplace_stencil_2d(self.unpad(u).contiguous(),
                                               self.h))
        dim = len(self.shape)
        out = None
        for d in range(dim):
            term = u
            for ax in range(dim):
                term = (self._stiff_axis(term, ax) if ax == d
                        else self._mass_axis(term, ax))
            out = term if out is None else out + term
        return self._mask_pad(out)

    def mass_diag(self) -> np.ndarray:
        """Assembled mass diagonal as the NumPy outer product of the 1D
        diagonals, flat (dof order), float64."""
        out = np.array(1.0)
        for ax in range(len(self.shape)):
            h, n = self.h[ax], self.shape[ax]
            m = np.full(n, 2.0 * h / 3.0)
            m[0] = m[-1] = h / 3.0
            out = np.multiply.outer(out, m)
        return out.reshape(-1)

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


def to_lattice(space: GridSpace, u_flat):
    """A flat dof vector of ``space`` as its lattice view."""
    return flat_to_lattice(u_flat, space.n_points_1d)


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
