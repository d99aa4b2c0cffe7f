"""Host float64 reference apply of the augmented DLM system.

Counterpart of ``HostAugmentedSystem`` and ``_axis_apply`` of
``fictitious_domain_al_preconditioners_tpu.ops.host_ref``
(``host_ref.py:131-235``).  The card solves in float32, but the reference's
solve-quality target is a 1e-10 absolute residual in float64.  These NumPy
applies reproduce the exact operator the float32 solver iterates on
(constrained lattice stiffness + particle AL term + coupling blocks) in
float64 on the host, so the refinement loop of
:meth:`..models.immersed_laplace.ImmersedLaplaceProblem.solve_refined` can
drive the true residual to that target.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["HostAugmentedSystem"]


def _axis_apply(v, off, diag, bdiag, axis):
    """3-point symmetric Toeplitz with boundary diagonal, along ``axis``."""
    v = np.moveaxis(v, axis, 0)
    out = diag * v
    out[:-1] += off * v[1:]
    out[1:] += off * v[:-1]
    out[0] += (bdiag - diag) * v[0]
    out[-1] += (bdiag - diag) * v[-1]
    return np.moveaxis(out, 0, axis)


def _host(t) -> np.ndarray:
    """A tensor (on any device) as a float64 NumPy array."""
    return t.detach().to("cpu", torch.float64).numpy()


class HostAugmentedSystem:
    """float64 apply and right-hand side of the augmented 2x2 system

        [ Aug  Cᵀ ] [u]   [P(b₀ + γ CᵀW⁻¹ g) + (I-P) g_D]
        [ C    0  ] [λ] = [g]

    with Aug = P(K + γ·Σ_q φφᵀ JxW)P + (I-P) (operator form, diagonal W),
    built from an :class:`~..models.immersed_laplace.ImmersedLaplaceProblem`
    after ``setup()`` (uniform Q1 lattice only): its coupling table
    (``prob.C.host``), immersed mass diagonal, Dirichlet mask and data and
    right-hand sides, moved to NumPy."""

    def __init__(self, prob):
        cfg = prob.cfg
        if not (cfg.use_operator_form and cfg.use_diagonal_inverse):
            raise ValueError("host reference apply: operator form + "
                             "diagonal W only")
        sp = prob.space
        if not hasattr(sp, "n_points_1d"):
            raise ValueError("host reference apply: uniform lattice only")
        self.shape = tuple(reversed(sp.n_points_1d))   # lattice axis order
        self.h = tuple(float(x) for x in reversed(sp.grid.h))
        self.gamma = cfg.gamma / prob.curve.h_max
        self.free = _host(prob.free).astype(bool)
        C = prob.C.host
        self.bg_dofs = np.asarray(C["bg_dofs"])
        self.bg_phi = np.asarray(C["bg_phi"], dtype=np.float64)
        self.imm_dofs = np.asarray(C["imm_dofs"])
        self.imm_psi = np.asarray(C["imm_psi"], dtype=np.float64)
        self.jxw = np.asarray(C["jxw"], dtype=np.float64)
        self.n = sp.n_dofs
        self.m = prob.imm_space.n_dofs
        self.inv_w = 1.0 / _host(prob.M.diag())
        self.rhs_f = _host(prob.rhs_f)
        self.rhs_g = _host(prob.rhs_g)
        self.bc = _host(prob.bc_values)

    # -- block actions -----------------------------------------------------

    def k_mv(self, u):
        ul = u.reshape(self.shape)
        out = np.zeros_like(ul)
        dim = len(self.shape)
        for d in range(dim):
            term = ul
            for ax in range(dim):
                h = self.h[ax]
                if ax == d:
                    term = _axis_apply(term, -1.0 / h, 2.0 / h, 1.0 / h, ax)
                else:
                    term = _axis_apply(term, h / 6.0, 2.0 * h / 3.0,
                                       h / 3.0, ax)
            out = out + term
        return out.reshape(-1)

    def al_mv(self, u):
        vals = np.einsum("qa,qa->q", u[self.bg_dofs], self.bg_phi) * self.jxw
        out = np.zeros(self.n)
        np.add.at(out, self.bg_dofs, self.bg_phi * vals[:, None])
        return self.gamma * out

    def c_mv(self, u):
        vals = np.einsum("qa,qa->q", u[self.bg_dofs], self.bg_phi) * self.jxw
        out = np.zeros(self.m)
        np.add.at(out, self.imm_dofs, self.imm_psi * vals[:, None])
        return out

    def ct_mv(self, lam):
        vals = np.einsum("qa,qa->q", lam[self.imm_dofs], self.imm_psi) * \
            self.jxw
        out = np.zeros(self.n)
        np.add.at(out, self.bg_dofs, self.bg_phi * vals[:, None])
        return out

    def aug_mv(self, u):
        m = self.free
        um = np.where(m, u, 0.0)
        return np.where(m, self.k_mv(um) + self.al_mv(um), u)

    def apply(self, u, lam):
        """Full block apply -> (row0, row1).  Cᵀ is not masked in row 0,
        matching the solver's outer operator."""
        return (self.aug_mv(u) + self.ct_mv(lam), self.c_mv(u))

    def rhs(self):
        """The augmented right-hand side (that of ``_augmented_run``)."""
        m = self.free
        g = np.where(m, 0.0, self.bc)
        b0 = np.where(m, self.rhs_f - self.k_mv(g), self.bc)
        b0 = b0 + np.where(m, self.gamma * self.ct_mv(self.inv_w * self.rhs_g),
                           0.0)
        return b0, self.rhs_g

    def residual(self, u, lam):
        b0, b1 = self.rhs()
        r0, r1 = self.apply(u, lam)
        return b0 - r0, b1 - r1
