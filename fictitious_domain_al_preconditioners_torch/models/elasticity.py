"""Elasticity interface problem (3D, and its 2D variant) with the modified
AL preconditioner.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.models.elasticity``
(the reference's ``elliptic_interface_elasticity`` executable, reconstructed
by the JAX package from ``ElasticityUtilities::assemble_elasticity``,
utilities.h:377-427, the AMG setup, utilities.h:429-587, and
parameters_elliptic_interface/elasticity.prm): linear elasticity

    λ(div u, div v) + 2μ(ε(u) : ε(v))

with a hyper_rectangle inclusion in a cube, Lamé jumps (λ: 2 → 20, μ: 1 →
10), vector multiplier coupling and the modified AL preconditioner (γ₁ = 10,
γ₂ = 1e-2, W = M² componentwise):

    [ A₁+γ₁CᵀW⁻¹C   -γ₁CᵀW⁻¹M      Cᵀ ] [u ]   [P f₁]
    [ -γ₂MW⁻¹C       A₂+γ₂MW⁻¹M    -M ] [u₂] = [f₂-f]
    [ C              -M             0  ] [λ ]   [0]

The A11 inner solves run on a flat vector GMG of the background whose
levels are A_l + γ₁·blockdiag(Cᵀdiag(w)C), one band stencil
(:func:`..ops.sparse_band.lattice_band_linop`) where the band takes it, else
the element-form A_l and the coupling applies; A22's on a flat vector GMG
of the immersed box's grid with levels A2_l + γ₂·I.  Every apply is element
form, the band's strided products or the coupling's gathers and
``index_add_``, as in the reference package, whose elasticity path reaches
no Pallas kernel: no kernel of this repo is on this path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.generators import background_grid_from_name
from ..core.grid import GridSpace
from ..core.immersed import ImmersedSpace, immersed_uniform_grid
from ..ops.assembly import (elasticity_block_local, imm_mass_matrix,
                            rhs_vector, vector_cell_dofs)
from ..ops.blocks import BlockLayout, block_operator
from ..ops.coupling import VectorCoupling, build_coupling
from ..ops.host_ref import HostElasticitySystem
from ..ops.krylov import cg, fgmres
from ..ops.linop import LinOp
from ..ops.operators import CellMatrix, constrain, dirichlet_rhs
from ..ops.sparse_band import vector_al_level
from ..precond.al import al_preconditioner_modified, block_solve
from ..precond.gmg import build_gmg_flat
from ..precond.weights import lattice_mass_inverse
from ..utils.prm import Params, parse_prm
from ..utils.refine import CORRECTION_MAX_OUTER
from ..utils.timer import TimerOutput
from .session import SolveSession, split_correction
from .elliptic_interface import ControlConfig

__all__ = ["ElasticityInterfaceConfig", "ElasticityInterfaceProblem"]


@dataclass
class ElasticityInterfaceConfig:
    """Mirror of the reconstructed executable's parameters; field names and
    defaults as in the JAX package."""

    dim: int = 3
    initial_background_refinement: int = 3
    initial_immersed_refinement: int = 2
    name_of_background_grid: str = "hyper_cube"
    arguments_for_background_grid: str = "-1.25: 1.25: true"
    name_of_immersed_grid: str = "hyper_rectangle"
    arguments_for_immersed_grid: str = "-0.65, -0.3, -0.4: 0.65, 0.3, 0.4: false"
    dirichlet_ids: tuple = (0, 1, 2, 3, 4, 5)
    background_space_degree: int = 1
    immersed_space_degree: int = 1
    coupling_quadrature_order: int = 5
    lambda_background: float = 2.0
    lambda_immersed: float = 20.0
    mu_background: float = 1.0
    mu_immersed: float = 10.0
    f: float = 1.0      # bulk load magnitude (per component)
    f_2: float = 2.0    # immersed load magnitude
    gamma_AL_background: float = 10.0
    gamma_AL_immersed: float = 1e-2
    use_modified_AL_preconditioner: bool = True
    use_diagonal_inverse: bool = False
    use_exact_mass_inverse_in_augmented_block: bool = False
    use_fixed_iterations: bool = False
    outer: ControlConfig = field(default_factory=lambda: ControlConfig(
        max_steps=1000, tolerance=1e-10, reduction=1e-6))
    inner: ControlConfig = field(default_factory=lambda: ControlConfig(
        max_steps=10000, tolerance=1e-2, reduction=1e-20))
    iteration_number: ControlConfig = field(default_factory=lambda: ControlConfig(
        max_steps=100, tolerance=1e-2, reduction=None))
    fgmres_restart: int = 50

    @classmethod
    def from_prm(cls, text_or_path) -> "ElasticityInterfaceConfig":
        text = text_or_path
        if "\n" not in str(text_or_path):
            with open(text_or_path) as fh:
                text = fh.read()
        p = Params(parse_prm(text)).enter("Elliptic Interface Problem")
        al = p.enter("AL preconditioner")
        grids = p.enter("Grid generation")
        ref = p.enter("Refinement and remeshing")

        def ctl(section, **d):
            s = p.enter(section)
            return ControlConfig(
                max_steps=s.get_int("Max steps", d.get("max_steps", 100)),
                tolerance=s.get_float("Tolerance", d.get("tolerance", 1e-10)),
                reduction=(s.get_float("Reduction", d["reduction"])
                           if "reduction" in d else None))

        return cls(
            initial_background_refinement=ref.get_int(
                "Initial background refinement", 3),
            initial_immersed_refinement=ref.get_int(
                "Initial immersed refinement", 2),
            name_of_background_grid=grids.get_str(
                "Background grid generator", "hyper_cube"),
            arguments_for_background_grid=grids.get_str(
                "Background grid generator arguments", "-1.25: 1.25: true"),
            name_of_immersed_grid=grids.get_str("Immersed grid generator",
                                                "hyper_rectangle"),
            arguments_for_immersed_grid=grids.get_str(
                "Immersed grid generator arguments",
                "-0.65, -0.3, -0.4: 0.65, 0.3, 0.4: false"),
            dirichlet_ids=tuple(p.get_int_list(
                "Homogeneous Dirichlet boundary ids", (0, 1, 2, 3, 4, 5))),
            background_space_degree=p.get_int("FE degree background", 1),
            immersed_space_degree=p.get_int("FE degree immersed", 1),
            coupling_quadrature_order=p.get_int("Coupling quadrature order",
                                                5),
            lambda_background=p.get_float("lambda background", 2.0),
            lambda_immersed=p.get_float("lambda immersed", 20.0),
            mu_background=p.get_float("mu background", 1.0),
            mu_immersed=p.get_float("mu immersed", 10.0),
            f=p.get_float("f", 1.0),
            f_2=p.get_float("f_2", 2.0),
            gamma_AL_background=al.get_float("gamma fluid", 10.0),
            gamma_AL_immersed=al.get_float("gamma solid", 1e-2),
            use_modified_AL_preconditioner=al.get_bool(
                "Use modified AL preconditioner", True),
            use_diagonal_inverse=al.get_bool("Use diagonal inverse", False),
            use_exact_mass_inverse_in_augmented_block=al.get_bool(
                "Use exact mass inverse in augmented block", False),
            use_fixed_iterations=p.get_bool("Use fixed (inner) iterations",
                                            False),
            outer=ctl("Outer solver control", max_steps=1000,
                      tolerance=1e-10, reduction=1e-6),
            inner=ctl("Inner solver control", max_steps=10000,
                      tolerance=1e-2, reduction=1e-20),
            iteration_number=ctl("Iteration number control", max_steps=100,
                                 tolerance=1e-2),
        )


class ElasticityInterfaceProblem:
    """``ElasticityInterfaceProblem(cfg).setup(cycle)`` then ``.solve()`` or
    ``.solve_refined()``.  The problem runs on the CUDA card unless
    ``device="cpu"`` is given.

    ``dtype`` sets the preconditioner's precision only: that of the A11 and
    A22 multigrid V-cycles, float64 on the CPU and float32 on CUDA by
    default.  The problem's arrays, the 3x3 operator, W⁻¹, the outer FGMRES,
    the inner CGs and the solution are float64 whatever ``dtype`` is, the
    split that the elliptic interface problem needed to refine at scale
    (a float32 operator loses the true residual where the Lamé jump
    multiplies A2's terms).  ``lanczos_start`` and ``lanczos_start_a22``
    (optional attributes, ``(level_index, n) -> ndarray``) inject the
    Lanczos start vectors of the A11 and A22 hierarchies
    (``n = dim·n_level``)."""

    # the precision of the operator and of every Krylov solver
    OP_DTYPE = torch.float64

    def __init__(self, config: ElasticityInterfaceConfig, *, device="cuda",
                 dtype=None):
        self.cfg = config
        self.device = torch.device(device)
        self.dtype = dtype or (torch.float64 if self.device.type == "cpu"
                               else torch.float32)
        self.timer = TimerOutput()
        self.results = {}
        self.stats = {"host_syncs": 0, "inner_iterations": 0}
        self.lanczos_start = None
        self.lanczos_start_a22 = None
        self.gamma_bg = config.gamma_AL_background
        self.gamma_imm = config.gamma_AL_immersed
        self._parts = {}
        self.session = SolveSession(self, "elasticity")

    # -- setup --------------------------------------------------------------

    def setup(self, cycle: int = 0):
        cfg = self.cfg
        dim = cfg.dim
        dev, dt = self.device, self.OP_DTYPE
        t0 = time.perf_counter()
        with self.timer.scope("Setup"):
            self.grid = background_grid_from_name(
                cfg.name_of_background_grid, cfg.arguments_for_background_grid,
                dim, cfg.initial_background_refinement + cycle)
            self.fg_grid = background_grid_from_name(
                cfg.name_of_immersed_grid, cfg.arguments_for_immersed_grid,
                dim, cfg.initial_immersed_refinement + cycle)
            self.fg_mesh = immersed_uniform_grid(self.fg_grid)
            self.space = GridSpace.q(self.grid, cfg.background_space_degree)
            self.fg_gridspace = GridSpace.q(self.fg_grid,
                                            cfg.immersed_space_degree)
            self.fg_space = ImmersedSpace(self.fg_mesh, self.fg_gridspace.fe,
                                          self.fg_gridspace.cell_dofs,
                                          self.fg_gridspace.n_dofs)

        with self.timer.scope("Assemble"):
            deg = cfg.background_space_degree
            n_bg, n_fg = self.space.n_dofs, self.fg_gridspace.n_dofs
            # A1: elasticity with (λ_bg, μ_bg) everywhere; A2: the Lamé
            # jump on the immersed grid
            self.A1 = self._elasticity_matrix(
                self.space, cfg.lambda_background, cfg.mu_background, dt)
            self.A2 = self._elasticity_matrix(
                self.fg_gridspace, cfg.lambda_immersed - cfg.lambda_background,
                cfg.mu_immersed - cfg.mu_background, dt)
            self.M = imm_mass_matrix(self.fg_space, order=deg + 1,
                                     device=dev, dtype=dt)
            rhs1 = rhs_vector(
                self.space, lambda p: cfg.f * np.ones((len(p), dim)),
                order=deg + 1, device=dev, dtype=dt)        # (n, dim)
            self.rhs_f1 = rhs1.T.reshape(-1)
            rhs2 = rhs_vector(
                self.fg_gridspace,
                lambda p: (cfg.f_2 - cfg.f) * np.ones((len(p), dim)),
                order=deg + 1, device=dev, dtype=dt)
            self.rhs_f2 = rhs2.T.reshape(-1)
            free_scalar = ~self.space.boundary_dof_mask(
                list(cfg.dirichlet_ids))
            self.free = torch.as_tensor(np.tile(free_scalar, dim),
                                        device=dev)

        with self.timer.scope("Coupling"):
            self.Cs = build_coupling(self.space, self.fg_space,
                                     order=deg + 1, device=dev, dtype=dt)
            self.C = VectorCoupling(self.Cs, dim)

        self.layout = BlockLayout((n_bg * dim, n_fg * dim, n_fg * dim))
        self._parts = {}
        self.session.reset()
        self.results["setup_seconds"] = time.perf_counter() - t0
        return self

    def load_state(self, state):
        """Replace the setup arrays by carried ones (see
        :func:`..utils.carry.state_from_jax`): right-hand sides, the
        Dirichlet mask, the scalar coupling table, the immersed mass and the
        Lanczos start vectors of both hierarchies.  The solver is rebuilt at
        the next solve."""
        self.rhs_f1, self.rhs_f2, self.free = (state.rhs_f1, state.rhs_f2,
                                               state.free)
        self.Cs = state.coupling
        self.C = VectorCoupling(self.Cs, self.cfg.dim)
        self.M = state.M
        for attr, starts in (("lanczos_start", state.lanczos_starts),
                             ("lanczos_start_a22",
                              state.lanczos_starts_a22)):
            if starts is not None:
                setattr(self, attr, lambda i, n, s=starts: s[i])
        self._parts = {}
        self.session.reset()
        return self

    # -- operators ------------------------------------------------------------

    def _elasticity_local(self, sp, lam, mu) -> np.ndarray:
        return elasticity_block_local(sp.fe, sp.grid.h,
                                      self.cfg.background_space_degree + 1,
                                      lam, mu)

    def _elasticity_matrix(self, sp, lam, mu, dtype) -> CellMatrix:
        """The vector elasticity matrix of a (level) space with Lamé
        coefficients (λ, μ): one shared local matrix."""
        vd = vector_cell_dofs(sp, self.cfg.dim)
        n = sp.n_dofs * self.cfg.dim
        return CellMatrix(vd, vd, self._elasticity_local(sp, lam, mu),
                          (n, n), device=self.device, dtype=dtype)

    def _imm_vec_op(self, scalar_cm) -> LinOp:
        """A scalar immersed matrix applied to every component."""
        dim = self.cfg.dim
        n = scalar_cm.shape[0]

        def mv(x):
            return scalar_cm.mv(x.reshape(dim, n).T).T.reshape(-1)

        return LinOp(mv, (n * dim, n * dim), mv)

    def _inv_w(self):
        """W⁻¹ = M⁻² componentwise by the tensor-product lattice inverse of
        the immersed box's Q1 grid (two Jacobi-CGs on a Q2 one), or
        diag(M)⁻²; and the scalar diagonal weights 1/diag(M)² of the GMG
        levels' AL term (float64 NumPy)."""
        dim = self.cfg.dim
        n = self.fg_gridspace.n_dofs
        d = self.M.diag_host()
        w_diag_scalar = 1.0 / d ** 2
        if self.cfg.use_diagonal_inverse:
            dinv2 = torch.as_tensor(w_diag_scalar, dtype=self.OP_DTYPE,
                                    device=self.device)

            def inv_w(lam):
                return (dinv2 * lam.reshape(dim, n)).reshape(-1)
        else:
            lat2 = lattice_mass_inverse(self.fg_gridspace, squared=True,
                                        device=self.device,
                                        dtype=self.OP_DTYPE)
            if lat2 is None:
                # a Q2 immersed box: M⁻¹ twice by Jacobi-CG on every
                # component at once (elasticity.py:264-273 of the reference)
                dinv = torch.as_tensor(1.0 / d, dtype=self.OP_DTYPE,
                                       device=self.device)[:, None]

                def m_inv(v):
                    x, _ = cg(self.M.mv, v, M=lambda r: dinv * r, tol=0.0,
                              reduction=1e-14, max_steps=1000,
                              stats=self.stats)
                    return x

                def lat2(v):
                    return m_inv(m_inv(v))

            def inv_w(lam):
                return lat2(lam.reshape(dim, n).T).T.reshape(-1)

        return inv_w, w_diag_scalar

    def _solver_parts(self):
        """The 3x3 operator and the modified AL preconditioner of the
        current γ's, built once (:meth:`solve` and the correction solves of
        :meth:`solve_refined` run on them).  The operator, W⁻¹ and every
        Krylov solver run in float64; the V-cycles in ``self.dtype``."""
        key = (round(self.gamma_bg, 12), round(self.gamma_imm, 12))
        if key in self._parts:
            return self._parts[key]
        cfg = self.cfg
        dim = cfg.dim
        dev, dt = self.device, self.dtype
        layout = self.layout
        gamma_1, gamma_2 = self.gamma_bg, self.gamma_imm
        free = self.free
        n_fg_s = self.fg_gridspace.n_dofs

        C_lin = LinOp(self.C.mv, self.C.shape, self.C.rmv)
        Ct_lin = C_lin.T
        M_vec = self._imm_vec_op(self.M)
        inv_w, w_diag_scalar = self._inv_w()
        A1_lin = constrain(self.A1.as_linop(), free)

        def A11_mv(x):
            # the AL term is not masked (elasticity.py:286-290 of the
            # reference package)
            return A1_lin(x) + gamma_1 * self.C.rmv(inv_w(self.C.mv(x)))

        routes = {"a11": [], "a22": []}
        lam_bg, mu_bg = cfg.lambda_background, cfg.mu_background

        def a11_factory(sp):
            local = self._elasticity_local(sp, lam_bg, mu_bg)
            A_l = (self.A1.astype(dt) if sp is self.space
                   else self._elasticity_matrix(sp, lam_bg, mu_bg, dt))
            Cl = self.Cs if sp is self.space else build_coupling(
                sp, self.fg_space, order=cfg.background_space_degree + 1,
                device="cpu")
            mv, diag, route = vector_al_level(
                sp, A_l, local, dim, Cl, w_diag_scalar, gamma_1, device=dev,
                dtype=dt)
            routes["a11"].append(route)
            return mv, diag

        gmg11 = build_gmg_flat(self.space, a11_factory, free_mask=free,
                               n_comp=dim, lanczos_start=self.lanczos_start,
                               dtype=dt, stats=self.stats)

        # A22 = A2 + γ₂·M W⁻¹ M (= A2 + γ₂·I for the exact W = M²)
        lam_j = cfg.lambda_immersed - cfg.lambda_background
        mu_j = cfg.mu_immersed - cfg.mu_background

        def A22_mv(x):
            return self.A2.mv(x) + gamma_2 * M_vec(inv_w(M_vec(x)))

        def a22_factory(sp):
            local = self._elasticity_local(sp, lam_j, mu_j)
            A_l = (self.A2.astype(dt) if sp is self.fg_gridspace
                   else self._elasticity_matrix(sp, lam_j, mu_j, dt))
            a_mv, a_diag, route = vector_al_level(sp, A_l, local, dim,
                                                  device=dev, dtype=dt)
            routes["a22"].append(route)

            def mv(x):
                return a_mv(x) + gamma_2 * x

            return mv, np.asarray(a_diag) + gamma_2

        gmg22 = build_gmg_flat(
            self.fg_gridspace, a22_factory,
            free_mask=torch.ones(n_fg_s * dim, dtype=torch.bool, device=dev),
            n_comp=dim, lanczos_start=self.lanczos_start_a22, dtype=dt,
            stats=self.stats)
        self.results["gmg_routes"] = routes

        inner_kw = (dict(tol=cfg.iteration_number.tolerance,
                         max_steps=cfg.iteration_number.max_steps,
                         fixed_iters=True) if cfg.use_fixed_iterations else
                    dict(tol=cfg.inner.tolerance,
                         reduction=cfg.inner.reduction,
                         max_steps=min(cfg.inner.max_steps, 1000)))

        def A11_inv(v):
            x, _ = block_solve(A11_mv, v, M=gmg11.apply, stats=self.stats,
                               **inner_kw)
            return x

        def A22_inv(v):
            x, _ = block_solve(A22_mv, v, M=gmg22.apply, stats=self.stats,
                               **inner_kw)
            return x

        def A12_mv(x):
            return -gamma_1 * Ct_lin(inv_w(M_vec(x)))

        def A21_mv(x):
            return -gamma_2 * M_vec(inv_w(C_lin(x)))

        n0, n1, _ = layout.sizes
        system_operator = block_operator(layout, layout, [
            [LinOp(A11_mv, (n0, n0)), LinOp(A12_mv, (n0, n1)), Ct_lin],
            [LinOp(A21_mv, (n1, n0)), LinOp(A22_mv, (n1, n1)), -1.0 * M_vec],
            [C_lin, -1.0 * M_vec, None]])
        prec = al_preconditioner_modified(layout, A11_inv, A22_inv, Ct_lin,
                                          M_vec, inv_w, gamma_1)
        parts = dict(system_operator=system_operator, prec=prec,
                     gmg11=gmg11, gmg22=gmg22)
        self._parts[key] = parts
        self._last_parts = parts
        return parts

    def _build_solver(self, raw_rhs: bool = False,
                      max_steps: int | None = None):
        """``run(rhs_f1, rhs_f2) -> (x, info)``, the block solution with the
        Dirichlet rows zeroed; with ``raw_rhs`` ``run_raw(r0, r1, r2) ->
        (x, info)`` for an assembled block right-hand side (the correction
        solve of :meth:`solve_refined`).  ``max_steps`` caps the outer steps
        (default ``cfg.outer.max_steps``)."""
        cfg = self.cfg
        parts = self._solver_parts()
        layout, free = self.layout, self.free
        if max_steps is None:
            max_steps = cfg.outer.max_steps

        def solve_core(b):
            return fgmres(parts["system_operator"], b, parts["prec"],
                          tol=cfg.outer.tolerance,
                          reduction=cfg.outer.reduction, max_steps=max_steps,
                          restart=cfg.fgmres_restart, stats=self.stats)

        if raw_rhs:
            def run_raw(r0, r1, r2):
                return solve_core(layout.concat((r0, r1, r2)))

            return run_raw

        A1_raw = self.A1.as_linop()

        def run(rhs_f1, rhs_f2):
            b0 = dirichlet_rhs(A1_raw, rhs_f1, free, torch.zeros_like(rhs_f1))
            b = layout.concat((b0, rhs_f2, torch.zeros(
                layout.sizes[2], dtype=b0.dtype, device=b0.device)))
            x, info = solve_core(b)
            u, u2, lam = layout.split(x)
            u = torch.where(free, u, 0.0)
            return layout.concat((u, u2, lam)), info

        return run

    # -- solve ----------------------------------------------------------------

    def solve(self) -> int:
        """Build the solver of the current γ's (once) and run it; returns the
        outer iterations.  ``results`` records them with convergence, the
        solve and build seconds, the host syncs, the inner CG iterations
        (``inner_iterations``) and the GMG levels' routes."""
        key = (round(self.gamma_bg, 12), round(self.gamma_imm, 12))
        x, info = self.session.solve("modified", key, self._build_solver,
                                     self.rhs_f1, self.rhs_f2)
        self.u, self.u2, self.lam = self.layout.split(x)
        self.results.update(
            dofs_background=self.layout.sizes[0],
            dofs_immersed=self.layout.sizes[1],
            outer_iterations=int(info.iterations),
            converged=bool(info.converged), residual=float(info.residual))
        return int(info.iterations)

    def build_correction_solver(self):
        """``(r0, r1, r2) -> (x, info)``: one AL-preconditioned FGMRES solve
        of the 3x3 system with a raw right-hand side, its outer steps capped
        at ``utils.refine.CORRECTION_MAX_OUTER`` (the inner engine of
        :meth:`solve_refined`)."""
        return self._build_solver(
            raw_rhs=True,
            max_steps=min(self.cfg.outer.max_steps, CORRECTION_MAX_OUTER))

    def solve_refined(self, tol_abs: float = 1e-10, max_refine: int = 12):
        """Iterative refinement to the reference's solve quality: correction
        solves on the device, the true float64 residual of the 3x3 system on
        the host (:class:`..ops.host_ref.HostElasticitySystem`), looped to
        ``tol_abs`` under the guard of
        :func:`..utils.refine.guarded_refinement`.

        Returns ``(u, u2, lam, history)``: float64 NumPy iterates and the
        accepted true residual norms.  ``results`` records the total outer
        iterations, the final residual, the accepted steps, convergence, the
        seconds of the loop, of the device corrections and of the host
        residuals, and the host syncs
        (:meth:`.session.SolveSession.refine`).  The host system and the
        correction solver are built once per :meth:`setup`, on the operators
        :meth:`solve` built."""
        (u, u2, lam), history = self.session.refine(
            HostElasticitySystem,
            lambda: split_correction(self.layout,
                                     self.build_correction_solver()),
            self.layout.sizes, self.OP_DTYPE, ("u", "u2", "lam"), tol_abs,
            max_refine)
        self.results.update(dofs_background=self.layout.sizes[0],
                            dofs_immersed=self.layout.sizes[1])
        return u, u2, lam, history

    # -- diagnostics --------------------------------------------------------

    def constraint_residual(self) -> float:
        """||C u - M u2||_inf."""
        return float(torch.max(torch.abs(
            self.C.mv(self.u) - self._imm_vec_op(self.M)(self.u2))))

    def run(self):
        self.setup()
        self.solve()
        return self.results
