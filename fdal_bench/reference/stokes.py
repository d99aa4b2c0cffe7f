"""Reference of ``stokes_immersed_boundary`` in 2D with the IBStokesAL
solver, grad-div stabilization and W = diag(M_Γ)² ("Diagonal mass
immersed"): Q2 velocity and Q1 pressure on the uniform lattice of
[0, 1]², Dirichlet velocity on all four sides, a P1 vector multiplier on
the immersed polygon, the augmented 3x3 system

    [ Aug  Bᵀ  Cᵀ ] [u]   [P(f - A g_D + γ CᵀW⁻¹g) + (I-P) g_D]
    [ B    0   0  ] [p] = [-B g_D]
    [ C    0   0  ] [λ]   [g - C g_D]

with A = (∇u:∇v) + γ_gd (div u, div v), B = -(div u, q), Aug = PAP + (I-P)
+ γ CᵀW⁻¹C, B and C taken on the free velocity only (Bᵀ and Cᵀ masked
likewise), C and the multiplier's load on a Gauss rule of 4 points a
segment.  Every velocity and pressure operator is a sum of products of
one-dimensional matrices.  torch in float64 on the given device."""

from __future__ import annotations

import numpy as np
import torch

from .expr import evaluate
from .fem import Polygon, lattice_basis, lattice_load, matrices_1d


class StokesReference:
    def __init__(self, problem: dict, modes: list, device):
        al = problem["al"]
        if not (al["grad_div_stabilization"] and al["inverse_diag_square"]
                and problem["spacedim"] == 2
                and problem["velocity_degree"] == 2
                and not problem["use_disc_pressure"]):
            raise ValueError("the reference holds 2D Taylor-Hood Q2-Q1 with "
                             "grad-div and W = diag(M_Γ)² only")
        dev = self.device = torch.device(device)
        n = self.n_cells = 2 ** problem["initial_refinement"]
        self.sv, self.sp = 2 * n + 1, n + 1
        self.nv, self.np_ = self.sv ** 2, self.sp ** 2
        self.m = 2 ** problem["initial_embedded_refinement"] + 1
        self.tol = problem["outer"]["tolerance"]
        self.reduction = problem["outer"]["reduction"]
        self.gamma = al["gamma"]
        self.gamma_gd = al["gamma_grad_div"]

        def mat(*args):
            return torch.as_tensor(matrices_1d(n, *args), dtype=torch.float64,
                                   device=dev)

        self.M2 = mat(2, 2, False, False)
        self.K2 = mat(2, 2, True, True)
        self.G = mat(2, 2, True, False)       # G[i, k] = ∫ φ_i' φ_k
        self.Nq = mat(1, 2, False, False)     # ∫ ψ_a φ_i
        self.Dq = mat(1, 2, False, True)      # ∫ ψ_a φ_i'
        self.curve = Polygon(*problem["embedded_configuration"],
                             problem["initial_embedded_refinement"])
        pts, psi, dofs, jxw = self.curve.quadrature(4)
        idx, val = lattice_basis(pts, n, 2)
        self.idx = torch.as_tensor(idx, device=dev)
        self.val = torch.as_tensor(val, dtype=torch.float64, device=dev)
        self.psi_w = torch.as_tensor(psi * jxw[:, None], dtype=torch.float64,
                                     device=dev)
        self.dofs = torch.as_tensor(dofs, device=dev)
        d = torch.as_tensor(self.curve.mass_diagonal(), dtype=torch.float64,
                            device=dev)
        self.inv_w = torch.cat([1.0 / d ** 2] * 2)
        edge = torch.zeros((self.sv, self.sv), dtype=torch.bool, device=dev)
        edge[0, :] = edge[-1, :] = edge[:, 0] = edge[:, -1] = True
        self.free = torch.cat([~edge.reshape(-1)] * 2)
        x1 = torch.linspace(0.0, 1.0, self.sv, dtype=torch.float64, device=dev)
        bc = evaluate(*problem["dirichlet_bc"],
                      (x1[None, :].expand(self.sv, self.sv),
                       x1[:, None].expand(self.sv, self.sv)))
        bc = torch.cat([torch.as_tensor(c, dtype=torch.float64, device=dev)
                        .expand(self.sv, self.sv).reshape(-1)
                        for c in bc[:2]])
        self.g_ext = torch.where(self.free, 0.0, bc)
        self.f_modes = torch.stack([
            lattice_load(*md["f"], n, 2, 4, 2, dev).T.reshape(-1)
            for md in modes])
        self.g_modes = torch.as_tensor(np.stack([
            self.curve.load(evaluate(*md["g"], pts), psi, dofs, jxw)
            .T.reshape(-1) for md in modes]), dtype=torch.float64, device=dev)

    # -- blocks ---------------------------------------------------------------

    def _split(self, u):
        return (u[:self.nv].reshape(self.sv, self.sv),
                u[self.nv:].reshape(self.sv, self.sv))

    def a_mv(self, u):
        """A u, unconstrained: the vector Laplacian plus grad-div."""
        ux, uy = self._split(u)
        M2, K2, G, g = self.M2, self.K2, self.G, self.gamma_gd
        lap_x = M2 @ ux @ K2 + K2 @ ux @ M2
        lap_y = M2 @ uy @ K2 + K2 @ uy @ M2
        gd_x = M2 @ ux @ K2 + G.T @ uy @ G.T
        gd_y = G @ ux @ G + K2 @ uy @ M2
        return torch.cat([(lap_x + g * gd_x).reshape(-1),
                          (lap_y + g * gd_y).reshape(-1)])

    def b_mv(self, u):
        ux, uy = self._split(u)
        return -(self.Nq @ ux @ self.Dq.T + self.Dq @ uy @ self.Nq.T).reshape(-1)

    def b_rmv(self, p):
        P = p.reshape(self.sp, self.sp)
        return -torch.cat([(self.Nq.T @ P @ self.Dq).reshape(-1),
                           (self.Dq.T @ P @ self.Nq).reshape(-1)])

    def c_mv(self, u):
        out = []
        for comp in self._split(u):
            s = (self.val * comp.reshape(-1)[self.idx]).sum(dim=1)
            o = torch.zeros(self.m, dtype=torch.float64, device=u.device)
            o.index_add_(0, self.dofs.reshape(-1),
                         (self.psi_w * s[:, None]).reshape(-1))
            out.append(o)
        return torch.cat(out)

    def c_rmv(self, lam):
        out = []
        for comp in (lam[:self.m], lam[self.m:]):
            s = (self.psi_w * comp[self.dofs]).sum(dim=1)
            o = torch.zeros(self.nv, dtype=torch.float64, device=lam.device)
            o.index_add_(0, self.idx.reshape(-1),
                         (self.val * s[:, None]).reshape(-1))
            out.append(o)
        return torch.cat(out)

    def _masked(self, u):
        return torch.where(self.free, u, 0.0)

    # -- system ---------------------------------------------------------------

    def rhs(self, coeffs):
        c = torch.as_tensor(np.asarray(coeffs, dtype=np.float64),
                            device=self.device)
        f, g = c @ self.f_modes, c @ self.g_modes
        g_ext = self.g_ext
        b0 = torch.where(self.free, f - self.a_mv(g_ext), g_ext)
        b0 = b0 + self._masked(self.gamma * self.c_rmv(self.inv_w * g))
        return b0, -self.b_mv(g_ext), g - self.c_mv(g_ext)

    def apply(self, u, p, lam):
        um = self._masked(u)
        aug = torch.where(self.free, self.a_mv(um), u)
        aug = aug + self._masked(self.gamma * self.c_rmv(
            self.inv_w * self.c_mv(um)))
        r0 = aug + self._masked(self.b_rmv(p)) + self._masked(self.c_rmv(lam))
        return r0, self.b_mv(um), self.c_mv(um)

    def judge(self, answer, coeffs):
        """``(residual, threshold)`` of the answer ``(u, p, λ)``, as
        :meth:`..laplace.LaplaceReference.judge`."""
        x = [torch.as_tensor(a, device=self.device).double() for a in answer]
        b = self.rhs(coeffs)
        r = self.apply(*x)
        res = float(torch.sqrt(sum(((bi - ri) ** 2).sum()
                                   for bi, ri in zip(b, r))))
        bn = float(torch.sqrt(sum((bi ** 2).sum() for bi in b)))
        return res, max(self.tol, self.reduction * bn)
