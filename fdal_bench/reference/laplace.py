"""Reference of ``immersed_laplace`` in the augmented solver's operator form
with W = diag(M) (immersed_laplace.cc's "Use operator version" and "Use
diagonal inverse"), on a uniform Q1 lattice of [0, 1]² with Dirichlet data
on all four sides and a P1 multiplier on the immersed polygon:

    [ Aug  Cᵀ ] [u]   [P(f - K g_D + γ CᵀW⁻¹g) + (I-P) g_D]
    [ C    0  ] [λ] = [g]

with Aug = P(K + γ Σ_q φφᵀ JxW)P + (I-P), γ = gamma / h_Γ, P the interior
points, the particle term on the Gauss rule of 3 points a segment, C on the
file's coupling rule.  torch in float64 on the given device."""

from __future__ import annotations

import numpy as np
import torch

from .expr import evaluate
from .fem import Polygon, lattice_basis, lattice_load


class _CurveRule:
    """One Gauss rule on the polygon, located in the lattice."""

    def __init__(self, curve, n_gauss, n_cells, device):
        pts, psi, dofs, jxw = curve.quadrature(n_gauss)
        idx, val = lattice_basis(pts, n_cells, 1)
        self.points = pts
        self.idx = torch.as_tensor(idx, device=device)
        self.val = torch.as_tensor(val, dtype=torch.float64, device=device)
        self.psi_w = torch.as_tensor(psi * jxw[:, None], dtype=torch.float64,
                                     device=device)
        self.dofs = torch.as_tensor(dofs, device=device)
        self.jxw = torch.as_tensor(jxw, dtype=torch.float64, device=device)

    def at_points(self, u):
        """u at the rule's points: Σ_k φ_k(x_q) u[idx_qk]."""
        return (self.val * u[self.idx]).sum(dim=1)

    def spread(self, s, n):
        """Σ_q φ(x_q) s_q into a lattice vector of length n."""
        out = torch.zeros(n, dtype=torch.float64, device=s.device)
        out.index_add_(0, self.idx.reshape(-1),
                       (self.val * s[:, None]).reshape(-1))
        return out


class LaplaceReference:
    def __init__(self, problem: dict, modes: list, device):
        if not (problem["use_operator_form"]
                and problem["use_diagonal_inverse"]):
            raise ValueError("the reference holds the operator form with "
                             "W = diag(M) only")
        self.device = torch.device(device)
        self.n_cells = 2 ** problem["initial_refinement"]
        side = self.n_cells + 1
        self.side = side
        self.n = side * side
        self.m = 2 ** problem["initial_embedded_refinement"] + 1
        self.tol = problem["schur"]["tolerance"]
        self.reduction = problem["schur"]["reduction"]
        self.curve = Polygon(*problem["embedded_configuration"],
                             problem["initial_embedded_refinement"])
        self.gamma = problem["gamma"] / self.curve.h_max
        # operator form: the particle term on 2k+1 = 3 points a segment
        self.particle = _CurveRule(self.curve, 3, self.n_cells, self.device)
        self.coupling = _CurveRule(self.curve,
                                   problem["coupling_quadrature_order"],
                                   self.n_cells, self.device)
        self.inv_w = torch.as_tensor(1.0 / self.curve.mass_diagonal(),
                                     dtype=torch.float64, device=self.device)
        edge = torch.zeros((side, side), dtype=torch.bool, device=self.device)
        edge[0, :] = edge[-1, :] = edge[:, 0] = edge[:, -1] = True
        self.free = ~edge.reshape(-1)
        x1 = torch.linspace(0.0, 1.0, side, dtype=torch.float64,
                            device=self.device)
        bc = evaluate(*problem["dirichlet_boundary"],
                      (x1[None, :].expand(side, side),
                       x1[:, None].expand(side, side)))
        self.bc = torch.as_tensor(bc, dtype=torch.float64,
                                  device=self.device).expand(side, side)
        self.bc = torch.where(self.free, 0.0, self.bc.reshape(-1))
        # load vectors of the modes, (n_modes, n) and (n_modes, m)
        g_rule = self.curve.quadrature(2)
        self.f_modes = torch.stack([
            lattice_load(*md["f"], self.n_cells, 1, 2, 1, self.device)[:, 0]
            for md in modes])
        self.g_modes = torch.as_tensor(np.stack([
            self.curve.load(evaluate(*md["g"], g_rule[0]), *g_rule[1:])
            for md in modes]), dtype=torch.float64, device=self.device)

    # -- blocks ---------------------------------------------------------------

    def k_mv(self, u):
        """The unconstrained Q1 stiffness (K0⊗M1 + M0⊗K1, equal cells): full
        stencils on interior points, whose rows are the only ones used."""
        U = torch.nn.functional.pad(u.reshape(self.side, self.side),
                                    (1, 1, 1, 1))

        def kx(A):   # 1D stiffness along x times h
            return 2 * A[:, 1:-1] - A[:, :-2] - A[:, 2:]

        def mx(A):   # 1D mass along x over h
            return (4 * A[:, 1:-1] + A[:, :-2] + A[:, 2:]) / 6.0

        out = mx(kx(U).T).T + kx(mx(U).T).T
        return out.reshape(-1)

    def c_mv(self, u):
        r = self.coupling
        s = r.at_points(u)
        out = torch.zeros(self.m, dtype=torch.float64, device=u.device)
        out.index_add_(0, r.dofs.reshape(-1),
                       (r.psi_w * s[:, None]).reshape(-1))
        return out

    def c_rmv(self, lam):
        r = self.coupling
        s = (r.psi_w * lam[r.dofs]).sum(dim=1)
        return r.spread(s, self.n)

    def particle_mv(self, u):
        r = self.particle
        return r.spread(r.at_points(u) * r.jxw, self.n)

    # -- system ---------------------------------------------------------------

    def rhs(self, coeffs):
        c = torch.as_tensor(np.asarray(coeffs, dtype=np.float64),
                            device=self.device)
        f, g = c @ self.f_modes, c @ self.g_modes
        b0 = torch.where(self.free, f - self.k_mv(self.bc), self.bc)
        b0 = b0 + torch.where(
            self.free, self.gamma * self.c_rmv(self.inv_w * g), 0.0)
        return b0, g

    def apply(self, u, lam):
        um = torch.where(self.free, u, 0.0)
        aug = torch.where(self.free, self.k_mv(um)
                          + self.gamma * self.particle_mv(um), u)
        return aug + self.c_rmv(lam), self.c_mv(u)

    def judge(self, answer, coeffs):
        """``(residual, threshold)``: the float64 norm of b - 𝒜x for the
        answer ``(u, λ)`` and the configuration's stopping threshold
        max(tolerance, reduction·‖b‖)."""
        u, lam = (torch.as_tensor(a, device=self.device).double()
                  for a in answer)
        b = self.rhs(coeffs)
        r = self.apply(u, lam)
        res = float(torch.sqrt(sum(((bi - ri) ** 2).sum()
                                   for bi, ri in zip(b, r))))
        bn = float(torch.sqrt(sum((bi ** 2).sum() for bi in b)))
        return res, max(self.tol, self.reduction * bn)
