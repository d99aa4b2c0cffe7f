"""Host float64 reference applies of the DLM block systems.

Counterpart of ``HostAugmentedSystem``, ``HostEllipticSystem``,
``HostStokesSystem``, ``HostNitscheSystem``, ``HostElasticitySystem``,
``_HostCellMat``, ``_HostVectorCoupling``, ``_host_cg`` and ``_axis_apply``
of ``fictitious_domain_al_preconditioners_tpu.ops.host_ref``
(``host_ref.py:25-611``).  The card solves in float32, but the reference's
solve-quality target is a 1e-10 absolute residual in float64.  These NumPy
applies reproduce the exact operator the float32 solver iterates on in
float64 on the host, so the refinement loops of
:meth:`..models.immersed_laplace.ImmersedLaplaceProblem.solve_refined`,
:meth:`..models.elliptic_interface.EllipticInterfaceProblem.solve_refined`,
:meth:`..models.stokes.StokesProblem.solve_refined`,
:meth:`..models.nitsche_bcs.NitscheProblem.solve_refined` and
:meth:`..models.elasticity.ElasticityInterfaceProblem.solve_refined` can
drive the true residual to that target.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["HostAugmentedSystem", "HostEllipticSystem", "HostStokesSystem",
           "HostNitscheSystem", "HostElasticitySystem"]


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


def _lattice_apply(v, shape, h, stiffness: bool):
    """Q1 mass (``M₁ ⊗ M₁``) or stiffness (``K₁ ⊗ M₁ + M₁ ⊗ K₁``) of a flat
    vector on a lattice of ``shape`` and cell sizes ``h`` (lattice axis
    order), float64."""
    ul = v.reshape(shape)
    dim = len(shape)

    def mass(term, ax):
        return _axis_apply(term, h[ax] / 6.0, 2.0 * h[ax] / 3.0,
                           h[ax] / 3.0, ax)

    if not stiffness:
        for ax in range(dim):
            ul = mass(ul, ax)
        return ul.reshape(-1)
    out = np.zeros_like(ul)
    for d in range(dim):
        term = ul
        for ax in range(dim):
            term = (_axis_apply(term, -1.0 / h[ax], 2.0 / h[ax], 1.0 / h[ax],
                                ax) if ax == d else mass(term, ax))
        out = out + term
    return out.reshape(-1)


def _host_cg(mv, b, dinv, tol=1e-14, max_steps=2000):
    """Plain float64 CG with diagonal preconditioning (host mass solves:
    the immersed mass matrices are well conditioned, ~30 iterations).
    ``b`` may be (n,) or (n, k)."""
    x = np.zeros_like(b)
    r = b - mv(x)
    z = dinv * r if np.ndim(dinv) == 0 or r.ndim == 1 else dinv[:, None] * r
    p = z.copy()
    rz = np.sum(r * z, axis=0)
    nb = max(float(np.sqrt(np.sum(b * b))), 1e-300)

    def _safe_div(a, b):
        return np.divide(a, b, out=np.zeros_like(a), where=b != 0)

    for _ in range(max_steps):
        Ap = mv(p)
        alpha = _safe_div(rz, np.sum(p * Ap, axis=0))
        x = x + alpha * p
        r = r - alpha * Ap
        if float(np.sqrt(np.sum(r * r))) <= tol * nb:
            break
        z = dinv * r if np.ndim(dinv) == 0 or r.ndim == 1 else \
            dinv[:, None] * r
        rz_new = np.sum(r * z, axis=0)
        p = z + _safe_div(rz_new, rz) * p
        rz = rz_new
    return x


class _HostCellMat:
    """float64 host apply of an :class:`~.operators.CellMatrix` (element
    form): gather, local matvec, bincount scatter.  Exactly the assembled
    matrix, in double precision, without materializing COO.  A
    :class:`~.operators.CellMatrixSum` applies as the sum of its parts."""

    def __init__(self, cm, scale: float = 1.0):
        self.shape = cm.shape
        self.parts = None
        if hasattr(cm, "parts"):
            self.parts = [_HostCellMat(p, scale) for p in cm.parts]
            return
        self.row = cm.row_dofs_host
        self.col = cm.col_dofs_host
        self.local = cm.local_host * scale
        self.coef = cm.coef_host
        self.shared = self.local.ndim == 2

    def mv(self, x):
        """y = A x; ``x`` may be (n,) or (n, k) (small k, host mass CG)."""
        if self.parts is not None:
            return sum(p.mv(x) for p in self.parts)
        xe = x[self.col]                 # (c, b) or (c, b, k)
        eq = "ab,cb...->ca..." if self.shared else "cab,cb...->ca..."
        ye = np.einsum(eq, self.local, xe)
        if self.coef is not None:
            ye = ye * (self.coef[:, None] if ye.ndim == 2
                       else self.coef[:, None, None])
        if x.ndim == 1:
            return np.bincount(self.row.reshape(-1), weights=ye.reshape(-1),
                               minlength=self.shape[0])
        out = np.zeros((self.shape[0], x.shape[1]))
        np.add.at(out, self.row, ye)
        return out

    def rmv(self, y):
        if self.parts is not None:
            return sum(p.rmv(y) for p in self.parts)
        ye = y[self.row]
        if self.coef is not None:
            ye = ye * self.coef[:, None]
        if self.shared:
            xe = ye @ self.local
        else:
            xe = np.einsum("cab,ca->cb", self.local, ye)
        return np.bincount(self.col.reshape(-1), weights=xe.reshape(-1),
                           minlength=self.shape[1])


class _HostCoupling:
    """float64 scalar coupling C and Cᵀ from a quad-point table."""

    def __init__(self, coupling):
        h = coupling.host
        self.bg_dofs = np.asarray(h["bg_dofs"])
        self.bg_phi = np.asarray(h["bg_phi"], dtype=np.float64)
        self.imm_dofs = np.asarray(h["imm_dofs"])
        self.imm_psi = np.asarray(h["imm_psi"], dtype=np.float64)
        self.jxw = np.asarray(h["jxw"], dtype=np.float64)
        self.m, self.n = coupling.shape

    def _at_quad(self, u):
        return np.einsum("qa,qa->q", u[self.bg_dofs], self.bg_phi) * self.jxw

    def mv(self, u):
        out = np.zeros(self.m)
        np.add.at(out, self.imm_dofs, self.imm_psi * self._at_quad(u)[:, None])
        return out

    def rmv(self, lam):
        vals = np.einsum("qa,qa->q", lam[self.imm_dofs],
                         self.imm_psi) * self.jxw
        out = np.zeros(self.n)
        np.add.at(out, self.bg_dofs, self.bg_phi * vals[:, None])
        return out

    def particle_mass(self, u):
        """Σ_q JxW φφᵀ u: the background mass on the coupling's curve."""
        out = np.zeros(self.n)
        np.add.at(out, self.bg_dofs, self.bg_phi * self._at_quad(u)[:, None])
        return out


class _HostVectorCoupling:
    """float64 componentwise vector coupling from a scalar quad-point table
    (:class:`.coupling.VectorCoupling` on component-major flat
    vectors)."""

    def __init__(self, scalar, sd: int):
        h = scalar.host
        self.sd = sd
        self.bg_dofs = np.asarray(h["bg_dofs"])
        self.bg_phi = np.asarray(h["bg_phi"], dtype=np.float64)
        self.imm_dofs = np.asarray(h["imm_dofs"])
        self.imm_psi = np.asarray(h["imm_psi"], dtype=np.float64)
        self.jxw = np.asarray(h["jxw"], dtype=np.float64)
        self.m, self.nu = scalar.shape

    def _s_mv(self, us):              # (nu, k) -> (m, k)
        vals = np.einsum("qak,qa->qk", us[self.bg_dofs],
                         self.bg_phi) * self.jxw[:, None]
        out = np.zeros((self.m, us.shape[1]))
        np.add.at(out, self.imm_dofs,
                  self.imm_psi[:, :, None] * vals[:, None, :])
        return out

    def _st_mv(self, lam_s):          # (m, k) -> (nu, k)
        vals = np.einsum("qak,qa->qk", lam_s[self.imm_dofs],
                         self.imm_psi) * self.jxw[:, None]
        out = np.zeros((self.nu, lam_s.shape[1]))
        np.add.at(out, self.bg_dofs,
                  self.bg_phi[:, :, None] * vals[:, None, :])
        return out

    def mv(self, u):
        return self._s_mv(u.reshape(self.sd, self.nu).T).T.reshape(-1)

    def rmv(self, lam):
        return self._st_mv(lam.reshape(self.sd, self.m).T).T.reshape(-1)


class _HostLatticeMat:
    """float64 host apply of the Q1 mass or stiffness of a uniform lattice
    space: the matrix of a :class:`_HostCellMat` on the same space, applied
    by separable 3-point passes (no element gather or scatter)."""

    def __init__(self, space, stiffness: bool, scale: float = 1.0):
        self.shape = tuple(reversed(space.n_points_1d))
        self.h = tuple(float(x) for x in reversed(space.grid.h))
        self.stiffness = stiffness
        self.scale = scale

    def mv(self, x):
        y = _lattice_apply(x, self.shape, self.h, self.stiffness)
        return y if self.scale == 1.0 else self.scale * y


def _is_lattice(space) -> bool:
    return (space is not None and space.fe.degree == 1 and space.continuous
            and hasattr(space, "n_points_1d"))


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
        self.C = _HostCoupling(prob.C)
        self.inv_w = 1.0 / _host(prob.M.diag())
        self.rhs_f = _host(prob.rhs_f)
        self.rhs_g = _host(prob.rhs_g)
        self.bc = _host(prob.bc_values)

    # -- block actions -----------------------------------------------------

    def k_mv(self, u):
        return _lattice_apply(u, self.shape, self.h, stiffness=True)

    def aug_mv(self, u):
        m = self.free
        um = np.where(m, u, 0.0)
        return np.where(m, self.k_mv(um)
                        + self.gamma * self.C.particle_mass(um), u)

    def apply(self, u, lam):
        """Full block apply -> (row0, row1).  Cᵀ is not masked in row 0,
        matching the solver's outer operator."""
        return (self.aug_mv(u) + self.C.rmv(lam), self.C.mv(u))

    def rhs(self):
        """The augmented right-hand side (that of ``_augmented_run``)."""
        m = self.free
        g = np.where(m, 0.0, self.bc)
        b0 = np.where(m, self.rhs_f - self.k_mv(g), self.bc)
        b0 = b0 + np.where(m, self.gamma * self.C.rmv(self.inv_w
                                                      * self.rhs_g), 0.0)
        return b0, self.rhs_g

    def residual(self, u, lam):
        b0, b1 = self.rhs()
        r0, r1 = self.apply(u, lam)
        return b0 - r0, b1 - r1


class HostEllipticSystem:
    """float64 host apply and right-hand side of the 3x3 block system of the
    elliptic interface problem

        [A11_aug  A12   Cᵀ ] [u ]   [P(f1 - β1 A1 g_D) + (I-P) g_D]
        [A21      A22   -M ] [u2] = [f2]
        [C        -M    0  ] [λ ]   [0]

    with A11_aug = P(β1 A1 + AL11)P + (I-P), A12 = -γ1 Cᵀ W⁻¹ M,
    A21 = -γ2 M W⁻¹ C, A22 = (β2-β1) A2 + γ2 M W⁻¹ M, as the solver of
    :class:`~..models.elliptic_interface.EllipticInterfaceProblem` builds
    them, for all four W variants (elliptic_interface.cc:700-739):
    W = diag(M·M) or M² in the default form, W = diag(M) or M in the
    h-scaled and operator forms.  A12 and Cᵀ are not masked in row 0, as in
    the solver's operator.

    On a uniform Q1 lattice (the background always; the immersed side when
    it has a lattice twin) A1, A2 and M apply by separable passes and the
    exact W⁻¹ is the tensor-product banded inverse, exact to machine
    precision; otherwise the element form applies and the exact inverses
    run as (nested) float64 Jacobi-CG.  Built from a problem after
    ``setup()``."""

    def __init__(self, prob):
        cfg = prob.cfg
        self.n = prob.space.n_dofs
        self.m = prob.fg_space.n_dofs
        self.beta_1 = float(prob.beta_1)
        gamma_1, gamma_2 = prob.gamma_bg, prob.gamma_imm
        if cfg.use_h_scaled_mass or cfg.use_operator_form:
            h_imm = prob.fg_mesh.h_max
            gamma_1, gamma_2 = gamma_1 / h_imm ** 2, gamma_2 / h_imm ** 2
        self.gamma_1, self.gamma_2 = float(gamma_1), float(gamma_2)

        fg_lat = prob.fg_gridspace if _is_lattice(prob.fg_gridspace) \
            else None
        self.A1 = (_HostLatticeMat(prob.space, True)
                   if _is_lattice(prob.space) else _HostCellMat(prob.A1))
        a2_scale = float(prob.A2_scale)
        if fg_lat is not None:
            self.A2 = _HostLatticeMat(fg_lat, True, scale=a2_scale)
            self.M = _HostLatticeMat(fg_lat, False)
        else:
            self.A2 = _HostCellMat(prob.A2, scale=a2_scale)
            self.M = _HostCellMat(prob.M)

        self.C = _HostCoupling(prob.C)

        # W variants: mass_w -> W = (diag(M) | M); else W = (diag(M·M) | M²)
        self.diag_w = bool(cfg.use_diagonal_inverse)
        self.mass_w = bool(cfg.use_h_scaled_mass or cfg.use_operator_form)
        self.mdiag_inv = 1.0 / _host(prob.M.diag())
        self.lat_inv = None
        if self.diag_w:
            if self.mass_w:
                self.w_diag = self.mdiag_inv
            else:
                from ..precond.weights import inv_diag_of_m_squared

                ones = torch.ones(self.m, dtype=prob.M.dtype,
                                  device=prob.device)
                self.w_diag = _host(inv_diag_of_m_squared(prob.M)(ones))
        elif fg_lat is not None:
            from ..precond.weights import lattice_mass_inverse

            self.lat_inv = lattice_mass_inverse(
                fg_lat, squared=not self.mass_w, device="cpu",
                dtype=torch.float64)

        self.operator_form = bool(cfg.use_operator_form)
        if self.operator_form:
            # particle AL quad table at the solver's quadrature order
            from .coupling import build_coupling

            self.Cp = _HostCoupling(build_coupling(
                prob.space, prob.fg_space,
                order=2 * cfg.background_space_degree + 1, device="cpu"))

        self.free = _host(prob.free).astype(bool)
        self.bc = _host(prob.bc_values)
        self.rhs_f1 = _host(prob.rhs_f1)
        self.rhs_f2 = _host(prob.rhs_f2)
        self._b = None

    # -- block actions -----------------------------------------------------

    def inv_w(self, x):
        """W⁻¹x for the active variant: diagonal, the lattice inverse, or
        Jacobi-CG in float64 (one solve for W = M, nested for W = M²)."""
        if self.diag_w:
            return self.w_diag * x
        if self.lat_inv is not None:
            return self.lat_inv(torch.from_numpy(x)).numpy()
        y = _host_cg(self.M.mv, x, self.mdiag_inv)
        return y if self.mass_w else _host_cg(self.M.mv, y, self.mdiag_inv)

    def al11_mv(self, u):
        if self.operator_form:
            return self.gamma_1 * self.Cp.particle_mass(u)
        return self.gamma_1 * self.C.rmv(self.inv_w(self.C.mv(u)))

    def a11_aug_mv(self, u):
        m = self.free
        um = np.where(m, u, 0.0)
        a = self.beta_1 * self.A1.mv(um) + self.al11_mv(um)
        return np.where(m, a, u)

    def a22_mv(self, u2):
        return self.A2.mv(u2) + self.gamma_2 * self.M.mv(
            self.inv_w(self.M.mv(u2)))

    def apply(self, u, u2, lam):
        """Full 3x3 block apply -> (row0, row1, row2)."""
        cu, mu2 = self.C.mv(u), self.M.mv(u2)
        r0 = (self.a11_aug_mv(u)
              - self.gamma_1 * self.C.rmv(self.inv_w(mu2))
              + self.C.rmv(lam))
        r1 = (-self.gamma_2 * self.M.mv(self.inv_w(cu))
              + self.a22_mv(u2) - self.M.mv(lam))
        return r0, r1, cu - mu2

    def rhs(self):
        if self._b is None:
            m = self.free
            g = np.where(m, 0.0, self.bc)
            b0 = np.where(m, self.rhs_f1 - self.beta_1 * self.A1.mv(g),
                          self.bc)
            self._b = (b0, self.rhs_f2, np.zeros(self.m))
        return self._b

    def residual(self, u, u2, lam):
        b0, b1, b2 = self.rhs()
        r0, r1, r2 = self.apply(u, u2, lam)
        return b0 - r0, b1 - r1, b2 - r2


class HostStokesSystem:
    """float64 host apply and right-hand side of the IBStokesAL 3x3 block
    system

        [Aug  Bᵀ  Cᵀ] [u]   [P(f - A g_D) + (I-P) g_D + γ P CᵀW⁻¹ g]
        [B    0   0 ] [p] = [-B g_D]
        [C    0   0 ] [λ]   [g - C g_D]

    with Aug = constrain(A) + γ CᵀW⁻¹C (+ γ_gd Bᵀ Mp⁻¹ B when the grad-div
    term is not assembled into A) and B, C condensed on the velocity, as
    :class:`~..models.stokes.StokesProblem` builds them.  W⁻¹ = diag(M_Γ)⁻²
    or (M_Γ⁻¹)² by float64 Jacobi-CG (stokes_immersed_boundary.cc:965-985).
    Built from a problem after ``setup()`` (or ``load_state``)."""

    def __init__(self, prob):
        cfg = prob.cfg
        self.sd = sd = cfg.spacedim
        self.gamma = float(cfg.al.gamma)
        self.gamma_gd = float(cfg.al.gamma_grad_div)
        self.grad_div_in_a = bool(cfg.al.grad_div_stabilization)
        self.A = _HostCellMat(prob.A)
        self.B = _HostCellMat(prob.B)
        self.Mp = _HostCellMat(prob.Mp)
        self.Mimm = _HostCellMat(prob.M_imm_s)
        self.mp_lump_inv = 1.0 / _host(prob.Mp.row_sums())
        self.m = prob.M_imm_s.shape[0]
        self.Cv = _HostVectorCoupling(prob.Cs, sd)
        self.diag_w = bool(cfg.al.inverse_diag_square)
        self.mdiag_inv = 1.0 / prob.M_imm_s.diag_host()
        self.free = _host(prob.free).astype(bool)
        self.bc = _host(prob.bc_values)
        self.rhs_u = _host(prob.rhs_u)
        self.rhs_g = _host(prob.rhs_g)

    def inv_w(self, lam):
        ls = lam.reshape(self.sd, self.m).T
        if self.diag_w:
            out = (self.mdiag_inv ** 2)[:, None] * ls
        else:
            out = _host_cg(self.Mimm.mv, _host_cg(self.Mimm.mv, ls,
                                                  self.mdiag_inv),
                           self.mdiag_inv)
        return out.T.reshape(-1)

    def mp_inv(self, p):
        return _host_cg(self.Mp.mv, p, self.mp_lump_inv)

    # -- block actions, condensed on the velocity ------------------------

    def _a_c(self, u):
        m = self.free
        return np.where(m, self.A.mv(np.where(m, u, 0.0)), u)

    def _b_c(self, u):
        return self.B.mv(np.where(self.free, u, 0.0))

    def _bt_c(self, p):
        return np.where(self.free, self.B.rmv(p), 0.0)

    def _c_c(self, u):
        return self.Cv.mv(np.where(self.free, u, 0.0))

    def _ct_c(self, lam):
        return np.where(self.free, self.Cv.rmv(lam), 0.0)

    def aug_mv(self, u):
        out = self._a_c(u) + self.gamma * self._ct_c(
            self.inv_w(self._c_c(u)))
        if not self.grad_div_in_a:
            out = out + self.gamma_gd * self._bt_c(
                self.mp_inv(self._b_c(u)))
        return out

    def apply(self, u, p, lam):
        """Full 3x3 block apply -> (row0, row1, row2)."""
        return (self.aug_mv(u) + self._bt_c(p) + self._ct_c(lam),
                self._b_c(u), self._c_c(u))

    def rhs(self):
        m = self.free
        g = np.where(m, 0.0, self.bc)
        b0 = np.where(m, self.rhs_u - self.A.mv(g), self.bc)
        b0 = b0 + np.where(m, self.gamma * self.Cv.rmv(
            self.inv_w(self.rhs_g)), 0.0)
        return b0, -self.B.mv(g), self.rhs_g - self.Cv.mv(g)

    def residual(self, u, p, lam):
        b0, b1, b2 = self.rhs()
        r0, r1, r2 = self.apply(u, p, lam)
        return b0 - r0, b1 - r1, b2 - r2


class HostNitscheSystem:
    """float64 host apply and right-hand side of the boundary-multiplier
    2x2 system of :class:`~..models.nitsche_bcs.NitscheProblem`

        [K + M + γ(1/h)Σφφᵀ   Cᵀ] [u]   [f + γ(1/h)(g, φ)_∂Ω]
        [C                    0 ] [λ] = [(g, μ)]

    (nitsche_bcs.cc:515-632), with the consistent augmentation of the bulk
    right-hand side.  No strong Dirichlet rows: the boundary condition is
    the multiplier equation.  K and M apply as separable lattice passes on
    a Q1 lattice, in element form otherwise.  Built from a problem after
    ``setup()`` (or ``load_state``)."""

    def __init__(self, prob):
        sp = prob.space
        if _is_lattice(sp):
            self.K = _HostLatticeMat(sp, True)
            self.Mbulk = _HostLatticeMat(sp, False)
        else:
            self.K = _HostCellMat(prob.K)
            self.Mbulk = _HostCellMat(prob.Mbulk)
        self.C = _HostCoupling(prob.C)
        self.gal = float(prob.cfg.gamma) / float(prob.bmesh.h_max)
        self.rhs_f = _host(prob.rhs_f)
        self.rhs_g = _host(prob.rhs_g)
        self.aug_rhs = prob._aug_rhs()

    def apply(self, u, lam):
        """Full block apply -> (row0, row1)."""
        r0 = (self.K.mv(u) + self.Mbulk.mv(u)
              + self.gal * self.C.particle_mass(u) + self.C.rmv(lam))
        return r0, self.C.mv(u)

    def rhs(self):
        return self.rhs_f + self.aug_rhs, self.rhs_g

    def residual(self, u, lam):
        b0, b1 = self.rhs()
        r0, r1 = self.apply(u, lam)
        return b0 - r0, b1 - r1


class HostElasticitySystem:
    """float64 host apply and right-hand side of the elasticity interface
    3x3 system of :class:`~..models.elasticity.ElasticityInterfaceProblem`
    (vector fields, component-major; homogeneous Dirichlet data)

        [A11   A12   Cᵀ ] [u ]   [P f1]
        [A21   A22   -M ] [u2] = [f2]
        [C     -M    0  ] [λ ]   [0]

    with A11 = P A1 P + (I-P) + γ1 CᵀW⁻¹C (the AL term not masked, as the
    solver builds it), A12 = -γ1 CᵀW⁻¹M, A21 = -γ2 MW⁻¹C,
    A22 = A2 + γ2 MW⁻¹M and W = M² componentwise: W⁻¹ = diag(M)⁻², or
    (M⁻¹)² by two float64 Jacobi-CGs.  Built from a problem after
    ``setup()`` (or ``load_state``)."""

    def __init__(self, prob):
        cfg = prob.cfg
        self.dim = cfg.dim
        self.gamma_1 = float(prob.gamma_bg)
        self.gamma_2 = float(prob.gamma_imm)
        self.A1 = _HostCellMat(prob.A1)
        self.A2 = _HostCellMat(prob.A2)
        self.Mimm = _HostCellMat(prob.M)
        self.Cv = _HostVectorCoupling(prob.Cs, self.dim)
        self.n_fg_s = prob.M.shape[0]
        self.diag_w = bool(cfg.use_diagonal_inverse)
        self.mdiag_inv = 1.0 / prob.M.diag_host()
        self.free = _host(prob.free).astype(bool)
        self.rhs_f1 = _host(prob.rhs_f1)
        self.rhs_f2 = _host(prob.rhs_f2)

    def m_vec(self, x):
        v = x.reshape(self.dim, self.n_fg_s).T
        return self.Mimm.mv(v).T.reshape(-1)

    def inv_w(self, lam):
        ls = lam.reshape(self.dim, self.n_fg_s).T
        if self.diag_w:
            out = (self.mdiag_inv ** 2)[:, None] * ls
        else:
            out = _host_cg(self.Mimm.mv, _host_cg(self.Mimm.mv, ls,
                                                  self.mdiag_inv),
                           self.mdiag_inv)
        return out.T.reshape(-1)

    def a11_mv(self, u):
        m = self.free
        a = np.where(m, self.A1.mv(np.where(m, u, 0.0)), u)
        return a + self.gamma_1 * self.Cv.rmv(self.inv_w(self.Cv.mv(u)))

    def a22_mv(self, u2):
        return self.A2.mv(u2) + self.gamma_2 * self.m_vec(
            self.inv_w(self.m_vec(u2)))

    def apply(self, u, u2, lam):
        """Full 3x3 block apply -> (row0, row1, row2)."""
        cu, mu2 = self.Cv.mv(u), self.m_vec(u2)
        r0 = (self.a11_mv(u) - self.gamma_1 * self.Cv.rmv(self.inv_w(mu2))
              + self.Cv.rmv(lam))
        r1 = (-self.gamma_2 * self.m_vec(self.inv_w(cu)) + self.a22_mv(u2)
              - self.m_vec(lam))
        return r0, r1, cu - mu2

    def rhs(self):
        b0 = np.where(self.free, self.rhs_f1, 0.0)
        return b0, self.rhs_f2, np.zeros(self.rhs_f2.shape[0])

    def residual(self, u, u2, lam):
        b0, b1, b2 = self.rhs()
        r0, r1, r2 = self.apply(u, u2, lam)
        return b0 - r0, b1 - r1, b2 - r2
