"""Immersed-boundary Poisson problem with a Lagrange-multiplier constraint on
an embedded curve Γ (the flagship DLM problem).

Counterpart of
``fictitious_domain_al_preconditioners_tpu.models.immersed_laplace`` on a
uniform Q1 background with Dirichlet conditions on all four sides:

    -Δu = f in Ω,   u = g on Γ,   u = g_D on ∂Ω
    [ K   Cᵀ ] [u]   [f]
    [ C   0  ] [λ] = [g]

Solver modes (``cfg.solver``, immersed_laplace.cc:502-951):

- ``augmented`` (the paper's method; operator-form AL term, W = diag(M)):
  outer FGMRES (CGS2) on ``[[Aug, Cᵀ], [C, 0]]`` with the AL
  preconditioner; ``Aug⁻¹`` is an inner CG preconditioned by a lattice GMG
  V-cycle that re-discretizes the AL term on every level.
- ``CG``: exact Schur complement ``S = C K⁻¹ Cᵀ`` by CG.
- ``ELMAN_triang``: BFBt block-triangular preconditioner, right GMRES.
- ``rational``: ``diag(K⁻¹, (−Δ_Γ)^{-1/2})`` with AAA poles; MINRES in
  float64, FGMRES in float32 (MINRES stagnates there).

The last three share ``K⁻¹``: a tight GMG-preconditioned CG on the
constrained stiffness.  Every inner vector is an (ny, nx) lattice tensor; the
flat dof vector is a view of the same buffer.

With ``use_bf16_multigrid`` the augmented solver's V-cycle runs in
bfloat16: every level operator is K1 in its bf16-storage form plus the
masked Γ-band AL term in bf16, smoothed by the unfused Chebyshev, while the
inner CG and the outer FGMRES stay in the working dtype.
:meth:`ImmersedLaplaceProblem.solve_refined` drives the augmented system to
a true float64 residual (``ops.host_ref``) by iterative refinement over
correction solves in the working dtype (``utils.refine``).

On CUDA the kernels carry the lattice work: K2 (``fused_augmented_2d``)
applies the augmented operator (``op``) and smooths (``pre``/``post``) on
every level whose Γ-band is interior, and smooths ``K⁻¹``'s levels in its
no-patch form; K1 (``masked_laplace_2d``) is the constrained stiffness of
``K⁻¹``, of a coarse level whose band touches ∂Ω, and, in bfloat16, of every
level of the bf16 V-cycle; K6 (``laplace_stencil_2d``, through
``LatticeOps.laplace``) is the unconstrained stiffness that lifts the
Dirichlet data.  On the CPU the same wrappers run their plain PyTorch
versions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.grid import GridSpace, UniformGrid
from ..core.immersed import parametrized_curve
from ..ops.assembly import (imm_mass_matrix, imm_rhs, imm_stiffness_matrix,
                            interpolate, rhs_vector)
from ..ops.blocks import BlockLayout, block_operator
from ..ops.coupling import build_coupling
from ..ops.kernels import (AugmentedStencil2D, fused_augmented_2d,
                           masked_laplace_2d)
from ..ops.krylov import cg, fgmres, gmres, minres
from ..ops.linop import LinOp
from ..ops.operators import dirichlet_rhs
from ..ops.host_ref import HostAugmentedSystem
from ..parallel.lattice import LatticeOps
from ..precond.al import al_preconditioner
from ..precond.gmg import FusedSmoother, build_gmg
from ..precond.rational import rational_preconditioner
from ..precond.weights import inv_diag
from ..utils.expressions import ParsedFunction
from ..utils.refine import CORRECTION_MAX_OUTER, guarded_refinement

__all__ = ["SolverControlConfig", "ImmersedLaplaceConfig",
           "ImmersedLaplaceProblem"]

# symmetric 5-plane compression of the 9-point patch: centre + the 4
# "positive" offsets (0,1), (1,0), (1,1), (1,-1), as w9[a, b] indices
_PLANES = ((1, 1), (1, 2), (2, 1), (2, 2), (2, 0))

SOLVERS = ("augmented", "CG", "ELMAN_triang", "rational")


@dataclass
class SolverControlConfig:
    max_steps: int = 1000
    tolerance: float = 1e-12
    reduction: float | None = 1e-12


@dataclass
class ImmersedLaplaceConfig:
    """Mirror of the reference's Parameters class (immersed_laplace.cc:70-233);
    field names and defaults as in the JAX package."""

    initial_refinement: int = 4
    delta_refinement: int = 0
    initial_embedded_refinement: int = 5
    dirichlet_ids: tuple = (0, 1, 2, 3)
    embedding_space_degree: int = 1
    embedded_space_degree: int = 1
    embedded_configuration_degree: int = 1
    coupling_quadrature_order: int = 3
    use_displacement: bool = False
    solver: str = "CG"
    use_operator_form: bool = False
    use_diagonal_inverse: bool = False
    schur: SolverControlConfig = field(default_factory=SolverControlConfig)
    embedded_configuration: tuple = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                     "R=.3, Cx=.4,Cy=.4")
    embedding_rhs: tuple = ("0", "")
    embedded_value: tuple = ("1", "")
    dirichlet_boundary: tuple = ("0", "")
    gamma: float = 10.0
    # FGMRES basis size; the V and Z bases take (2*restart+1) vectors
    fgmres_restart: int = 50
    inner_max_steps: int = 100
    inner_tolerance: float = 1e-2
    use_bf16_multigrid: bool = False
    gmg_smoother_degree: int = 4


class ImmersedLaplaceProblem:
    """``ImmersedLaplaceProblem(cfg).setup()`` then ``.solve()``.  The
    problem runs on the CUDA card unless ``device="cpu"`` is given; ``dtype``
    defaults to float64 on the CPU and float32 on CUDA.
    ``lanczos_start(level_index, n) -> ndarray`` (optional attribute)
    injects the GMG Lanczos start vectors (those of the augmented operator's
    hierarchy and of ``K⁻¹``'s, which has the same levels)."""

    def __init__(self, config: ImmersedLaplaceConfig, *, device="cuda",
                 dtype=None):
        self.cfg = config
        self.device = torch.device(device)
        self.dtype = dtype or (torch.float64 if self.device.type == "cpu"
                               else torch.float32)
        self.results = {}
        self.stats = {"host_syncs": 0}
        self.lanczos_start = None
        self._solvers = {}
        self._refine_cache = None

    def _check_supported(self):
        cfg = self.cfg
        if cfg.solver not in SOLVERS:
            raise ValueError(f"unknown solver {cfg.solver!r}; one of "
                             f"{SOLVERS}")
        missing = []
        if cfg.solver == "augmented" and (not cfg.use_operator_form
                                          or not cfg.use_diagonal_inverse):
            missing.append("the augmented solver other than operator form "
                           "+ diagonal inverse")
        if cfg.delta_refinement:
            missing.append("delta_refinement")
        if cfg.embedding_space_degree != 1 or cfg.embedded_space_degree != 1:
            missing.append("element degrees other than 1")
        if set(cfg.dirichlet_ids) != {0, 1, 2, 3}:
            missing.append("partial Dirichlet boundaries")
        if missing:
            raise NotImplementedError("not ported yet: " + "; ".join(missing))

    # -- setup --------------------------------------------------------------

    def setup(self):
        self._check_supported()
        cfg = self.cfg
        dev, dt = self.device, self.dtype
        conf = ParsedFunction(*cfg.embedded_configuration)
        if cfg.use_displacement:
            def conf_fn(pts):
                return pts[:, :2] + np.asarray(conf(pts))
        else:
            def conf_fn(pts):
                return np.asarray(conf(pts))
        self.curve = parametrized_curve(
            conf_fn, cfg.initial_embedded_refinement,
            geom_degree=cfg.embedded_configuration_degree)
        self.imm_space = self.curve.space(cfg.embedded_space_degree)
        self.grid = UniformGrid.hyper_cube(2, 0.0, 1.0, cfg.initial_refinement)
        self.space = GridSpace.q(self.grid, cfg.embedding_space_degree)
        # mesh-compatibility guard (immersed_laplace.cc:364-369)
        if self.curve.h_max >= self.grid.cell_diameter:
            raise ValueError(
                "The embedding grid is too refined (or the embedded grid "
                "is too coarse): "
                f"h_Gamma={self.curve.h_max:.3e} >= "
                f"h_Omega={self.grid.cell_diameter:.3e}")

        deg, kdeg = cfg.embedding_space_degree, cfg.embedded_space_degree
        self.f_fn = ParsedFunction(*cfg.embedding_rhs)
        self.g_fn = ParsedFunction(*cfg.embedded_value)
        self.bc_fn = ParsedFunction(*cfg.dirichlet_boundary)
        self.rhs_f = rhs_vector(self.space, self.f_fn, order=deg + 1,
                                device=dev, dtype=dt)
        self.M = imm_mass_matrix(self.imm_space, order=max(kdeg + 1, 2),
                                 device=dev, dtype=dt)
        self.A_imm = imm_stiffness_matrix(self.imm_space, order=deg + 1,
                                          device=dev, dtype=dt)
        self.rhs_g = imm_rhs(self.imm_space, self.g_fn,
                             order=max(kdeg + 1, 2), device=dev, dtype=dt)
        self.free = torch.as_tensor(
            ~self.space.boundary_dof_mask(list(cfg.dirichlet_ids)), device=dev)
        self.bc_values = interpolate(self.space, self.bc_fn, device=dev,
                                     dtype=dt)
        self.C = build_coupling(self.space, self.imm_space,
                                cfg.coupling_quadrature_order, device=dev,
                                dtype=dt)
        self.layout = BlockLayout((self.space.n_dofs, self.imm_space.n_dofs))
        self._solvers = {}
        self._refine_cache = None
        return self

    def load_state(self, state):
        """Replace the setup arrays by carried ones (see
        :func:`..utils.carry.state_from_jax`); the solver is rebuilt at the
        next solve."""
        self.rhs_f, self.rhs_g = state.rhs_f, state.rhs_g
        self.bc_values, self.free = state.bc_values, state.free
        self.C, self.M = state.coupling, state.mass
        if state.stiffness is not None:
            self.A_imm = state.stiffness
        if state.lanczos_starts is not None:
            starts = state.lanczos_starts
            self.lanczos_start = lambda i, n: starts[i]
        self._solvers = {}
        self._refine_cache = None
        return self

    # -- solve ----------------------------------------------------------------

    def solve(self):
        """Build the solver of ``cfg.solver`` (once per setup) and run it.
        Returns ``(u, lam, SolveInfo)``; ``results`` records the outer
        iterations, convergence, solve seconds and host syncs of this
        solve."""
        key = self.cfg.solver
        if key not in self._solvers:
            builder = {"augmented": self._augmented_run,
                       "CG": self._build_schur_cg,
                       "ELMAN_triang": self._build_elman,
                       "rational": self._build_rational}[key]
            t0 = time.perf_counter()
            self._solvers[key] = builder()
            self.results["build_seconds"] = time.perf_counter() - t0
        self.stats["host_syncs"] = 0
        t0 = time.perf_counter()
        u, lam, info = self._solvers[key](self.rhs_f, self.rhs_g,
                                          self.bc_values)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.u, self.lam = u, lam
        self.results.update(
            outer_iterations=int(info.iterations),
            residual=float(info.residual),
            converged=bool(info.converged),
            solve_seconds=time.perf_counter() - t0,
            host_syncs=self.stats["host_syncs"],
            dofs_background=self.space.n_dofs,
            dofs_immersed=self.imm_space.n_dofs)
        return u, lam, info

    def _level_operator(self, sp, coupling, gamma, dtype=None):
        """Masked augmented operator of one lattice level: ``(op, diag,
        smoother_builder)`` for :func:`..precond.gmg.build_gmg`, and the
        level's :class:`AugmentedStencil2D` (None on a compact-AL level and
        in bfloat16).

        In the working dtype a level whose Γ-band is interior is K2 (``op``,
        and ``pre``/``post`` as its smoother).  In bfloat16 (``dtype``, the
        bf16 V-cycle) it is K1's bf16 form plus the masked 9-point patch in
        bf16, with the unfused Chebyshev smoother: the reference has no bf16
        form of the fused kernel (``pallas_kernels.py:451-452``).  A level
        whose band touches ∂Ω is K1 plus the masked compact AL block in
        either dtype."""
        dev, dt = self.device, self.dtype
        lat = LatticeOps.for_space(sp)
        ny, nx = lat.shape
        k_diag = lat.laplace_diag()
        free = ~sp.boundary_dof_mask(list(self.cfg.dirichlet_ids))
        bf16 = dtype == torch.bfloat16
        pw = None if bf16 else coupling.patch_w9(sp, gamma)
        if pw is not None:
            box, w9 = pw
            r0, c0, pr, pc = box
            planes = torch.as_tensor(np.stack([w9[a, b] for a, b in _PLANES]),
                                     dtype=dt, device=dev)
            st = AugmentedStencil2D(lat.h, lat.shape, planes, box)
            al_diag = np.zeros((ny, nx))
            al_diag[r0:r0 + pr, c0:c0 + pc] = w9[1, 1]

            def op(x2):
                return fused_augmented_2d("op", st, x2)

            def smoother_builder(lam, degree, eig_ratio):
                kw = dict(lam_max=lam, degree=degree, eig_ratio=eig_ratio)
                return FusedSmoother(
                    lambda b: fused_augmented_2d("smooth", st, b, **kw),
                    pre=lambda b: fused_augmented_2d("pre", st, b, **kw),
                    post=lambda b, x0: fused_augmented_2d("post", st, b, x0,
                                                          **kw))

            return (op, k_diag + al_diag.reshape(-1), smoother_builder), st

        al = (coupling.patch_al_lattice(sp, gamma, free=free, dtype=dtype)
              if bf16 else None)
        if al is not None:
            al_mv2, al_diag = al

            def op(x2):
                return masked_laplace_2d(x2, lat.h) + al_mv2(x2)

            return (op, k_diag + al_diag, None), None

        # Γ-band touches ∂Ω on this (coarse) level: compact AL block
        al, al_diag = coupling.compact_al(gamma, dtype=dtype)
        m = torch.as_tensor(free.reshape(ny, nx), device=dev)

        def op(x2):
            al_x = al(torch.where(m, x2, 0.0).reshape(-1)).reshape(ny, nx)
            return masked_laplace_2d(x2, lat.h) + torch.where(m, al_x, 0.0)

        return (op, k_diag + al_diag, None), None

    def _augmented_run(self, raw_rhs: bool = False,
                       max_steps: int | None = None):
        """The flagship solve: returns ``run(rhs_f, rhs_g, bc_values) ->
        (u, lam, info)``.  With ``raw_rhs`` it returns ``run_raw(b0, b1) ->
        (u, lam, info)``, one solve of the augmented system for an assembled
        block right-hand side (no Dirichlet lift, no AL right-hand side): the
        correction solve of :meth:`solve_refined`.  ``max_steps`` caps the
        outer steps (default ``cfg.schur.max_steps``, read when the solver is
        built)."""
        cfg = self.cfg
        dev, dt = self.device, self.dtype
        gamma = cfg.gamma / self.curve.h_max
        C_lin = self.C.as_linop()
        Ct_lin = C_lin.T
        layout = self.layout
        free = self.free
        inv_w = inv_diag(self.M)
        shape = LatticeOps.for_space(self.space).shape
        n = self.space.n_dofs
        if max_steps is None:
            max_steps = cfg.schur.max_steps
        gmg_dt = torch.bfloat16 if cfg.use_bf16_multigrid else dt

        def particle_coupling(sp):
            return build_coupling(
                sp, self.imm_space, order=2 * cfg.embedding_space_degree + 1,
                device=dev, dtype=dt)

        # the fine augmented operator of the inner CG, in the working dtype
        fine_coupling = particle_coupling(self.space)
        fine_level, fine_stencil = self._level_operator(
            self.space, fine_coupling, gamma)
        aug_lat = fine_level[0]

        self.level_stencils = []   # per GMG level, fine first

        def op_factory(sp):
            if sp is self.space and gmg_dt == dt:
                level, st = fine_level, fine_stencil
            else:
                coupling = (fine_coupling if sp is self.space
                            else particle_coupling(sp))
                level, st = self._level_operator(sp, coupling, gamma,
                                                 dtype=gmg_dt)
            self.level_stencils.append(st)
            return level

        gmg = build_gmg(self.space, op_factory, free_mask=free,
                        smoother_degree=cfg.gmg_smoother_degree,
                        lanczos_start=self.lanczos_start, dtype=gmg_dt,
                        stats=self.stats)
        self._last_gmg = gmg

        def aug_mv(x):
            return aug_lat(x.reshape(shape)).reshape(-1)

        Aug = LinOp(aug_mv, (n, n), aug_mv, name="Aug")

        def aug_inv(v):
            x2, _ = cg(aug_lat, v.reshape(shape), M=gmg.apply,
                       tol=cfg.inner_tolerance, max_steps=cfg.inner_max_steps,
                       stats=self.stats)
            return x2.reshape(-1)

        AA = block_operator(layout, layout, [[Aug, Ct_lin], [C_lin, None]])
        prec = al_preconditioner(layout, aug_inv, Ct_lin, inv_w, gamma)
        # FGMRES keeps the V and Z bases, 2*restart+1 vectors: the restart is
        # capped so that they fit about 6 GB on very large layouts (never
        # engaged at the ~4-30 outer iterations of this method)
        restart = min(cfg.fgmres_restart,
                      max(12, int(6e9 / (8 * max(layout.total, 1)))))

        def solve_core(b):
            return fgmres(AA, b, prec, tol=cfg.schur.tolerance,
                          reduction=cfg.schur.reduction, max_steps=max_steps,
                          restart=restart, stats=self.stats)

        if raw_rhs:
            def run_raw(b0, b1):
                x, info = solve_core(layout.concat((b0, b1)))
                u, lam = layout.split(x)
                return u, lam, info

            return run_raw

        k_mv = self._k_mv()

        def run(rhs_f, rhs_g, bc_values):
            b0 = dirichlet_rhs(k_mv, rhs_f, free, bc_values)
            b0 = b0 + torch.where(free, gamma * Ct_lin(inv_w(rhs_g)), 0.0)
            x, info = solve_core(layout.concat((b0, rhs_g)))
            u, lam = layout.split(x)
            return torch.where(free, u, bc_values), lam, info

        return run

    def build_correction_solver(self):
        """``(b0, b1) -> (du, dlam, info)``: one AL-preconditioned FGMRES
        solve of the augmented system with a raw right-hand side, its outer
        steps capped at ``utils.refine.CORRECTION_MAX_OUTER`` (the inner
        engine of :meth:`solve_refined`)."""
        return self._augmented_run(
            raw_rhs=True,
            max_steps=min(self.cfg.schur.max_steps, CORRECTION_MAX_OUTER))

    def solve_refined(self, tol_abs: float = 1e-10, max_refine: int = 12):
        """Mixed-precision iterative refinement to the reference's solve
        quality: correction solves in the working dtype (float32 on the
        card) produce corrections; the true residual of the augmented system
        is evaluated in float64 on the host (:mod:`..ops.host_ref`), and the
        loop runs until it reaches ``tol_abs``, the reference configs'
        1e-10, under the guard of
        :func:`..utils.refine.guarded_refinement` (its 64x growth cap).

        Returns ``(u, lam, history)``: float64 NumPy iterates and the
        accepted true residual norms.  ``results`` records the total outer
        iterations, the final residual, the accepted steps, convergence,
        the seconds of the whole loop, of the device correction solves and
        of the host residuals, and the host syncs.  The host system and the
        correction solver are built once per :meth:`setup`."""
        if self._refine_cache is None:
            t0 = time.perf_counter()
            self._refine_cache = (HostAugmentedSystem(self),
                                  self.build_correction_solver())
            self.results["refine_build_seconds"] = time.perf_counter() - t0
        host, corr = self._refine_cache
        dev, dt = self.device, self.dtype
        seconds = {"host": 0.0, "device": 0.0}

        def residual(*xs):
            t0 = time.perf_counter()
            rs = host.residual(*xs)
            seconds["host"] += time.perf_counter() - t0
            return rs

        def correct(rs):
            t0 = time.perf_counter()
            du, dlam, info = corr(*(torch.as_tensor(r, dtype=dt, device=dev)
                                    for r in rs))
            parts = [du.double().cpu().numpy(), dlam.double().cpu().numpy()]
            self.stats["host_syncs"] += 1      # the correction's copy back
            seconds["device"] += time.perf_counter() - t0
            return parts, int(info.iterations)

        self.stats["host_syncs"] = 0
        t0 = time.perf_counter()
        (u, lam), history, total_iters, converged = guarded_refinement(
            residual, correct, (self.space.n_dofs, self.imm_space.n_dofs),
            tol_abs, max_refine)
        elapsed = time.perf_counter() - t0
        self.u = torch.as_tensor(u, dtype=dt, device=dev)
        self.lam = torch.as_tensor(lam, dtype=dt, device=dev)
        self.results.update(
            outer_iterations=total_iters, refined_residual=history[-1],
            refine_steps=len(history) - 1, converged=converged,
            solve_seconds=elapsed, correction_seconds=seconds["device"],
            host_residual_seconds=seconds["host"],
            host_syncs=self.stats["host_syncs"],
            dofs_background=self.space.n_dofs,
            dofs_immersed=self.imm_space.n_dofs)
        return u, lam, history

    def _k_mv(self):
        """The unconstrained fine stiffness on flat vectors (kernel K6 on
        CUDA), which lifts the Dirichlet data."""
        lat = LatticeOps.for_space(self.space)

        def k_mv(x):
            return lat.laplace(x.reshape(lat.shape)).reshape(-1)

        return k_mv

    def _kg_inv(self, reduction=1e-13):
        """Tight GMG-preconditioned CG inverse of the constrained stiffness
        (the reference's stand-in for UMFPACK/AMG, immersed_laplace.py:234-281
        of the JAX package, lattice branch).  Every level operator is K1, the
        smoother is K2 without patch, the level diagonal ``laplace_diag``.
        CG stops on its recurrence residual at ``reduction`` of the initial
        one.  Returns ``(K_c, K_inv)`` on flat vectors."""
        dev, dt = self.device, self.dtype
        shape = LatticeOps.for_space(self.space).shape
        self.kinv_stencils = []   # per GMG level, fine first

        def factory(sp):
            lat = LatticeOps.for_space(sp)
            st = AugmentedStencil2D(lat.h, lat.shape, device=dev, dtype=dt)
            self.kinv_stencils.append(st)

            def op(x2):
                return masked_laplace_2d(x2, lat.h)

            def smoother_builder(lam, degree, eig_ratio):
                kw = dict(lam_max=lam, degree=degree, eig_ratio=eig_ratio)
                return FusedSmoother(
                    lambda b: fused_augmented_2d("smooth", st, b, **kw),
                    pre=lambda b: fused_augmented_2d("pre", st, b, **kw),
                    post=lambda b, x0: fused_augmented_2d("post", st, b, x0,
                                                          **kw))

            return op, lat.laplace_diag(), smoother_builder

        gmg = build_gmg(self.space, factory, free_mask=self.free,
                        lanczos_start=self.lanczos_start, dtype=dt,
                        stats=self.stats)
        self._kinv_gmg = gmg
        k_lat = gmg.levels[0].op
        n = self.space.n_dofs

        def k_c(x):
            return k_lat(x.reshape(shape)).reshape(-1)

        def K_inv(v):
            x2, _ = cg(k_lat, v.reshape(shape), M=gmg.apply, tol=0.0,
                       reduction=reduction, max_steps=2000, stats=self.stats)
            return x2.reshape(-1)

        return LinOp(k_c, (n, n), k_c, name="K_c"), K_inv

    def _build_schur_cg(self):
        """Exact-Schur CG (immersed_laplace.cc:507-525)."""
        cfg = self.cfg
        _, K_inv = self._kg_inv()
        C_lin = self.C.as_linop()
        Ct_lin = C_lin.T
        free = self.free
        k_mv = self._k_mv()

        def run(rhs_f, rhs_g, bc_values):
            b0 = dirichlet_rhs(k_mv, rhs_f, free, bc_values)

            def S(lam):
                return C_lin(K_inv(Ct_lin(lam)))

            rhs = C_lin(K_inv(b0)) - rhs_g
            lam, info = cg(S, rhs, tol=cfg.schur.tolerance,
                           reduction=cfg.schur.reduction,
                           max_steps=cfg.schur.max_steps, stats=self.stats)
            u = K_inv(b0 - Ct_lin(lam))
            return torch.where(free, u, bc_values), lam, info

        return run

    def _build_elman(self):
        """Elman BFBt block-triangular GMRES (immersed_laplace.cc:526-584)."""
        cfg = self.cfg
        K_c, K_inv = self._kg_inv()
        C_lin = self.C.as_linop()
        Ct_lin = C_lin.T
        layout = self.layout
        free = self.free
        k_mv = self._k_mv()

        def CCt(lam):
            return C_lin(Ct_lin(lam))

        def CCt_inv(v):
            x, _ = cg(CCt, v, tol=1e-12, max_steps=40, fixed_iters=True,
                      stats=self.stats)
            return x

        def S_inv(v):
            return CCt_inv(C_lin(K_c(Ct_lin(CCt_inv(v)))))

        def prec(x):
            x0, x1 = layout.split(x)
            s = S_inv(x1)
            return layout.concat((K_inv(x0) + K_inv(Ct_lin(s)), -s))

        AA = block_operator(layout, layout, [[K_c, Ct_lin], [C_lin, None]])

        def run(rhs_f, rhs_g, bc_values):
            b0 = dirichlet_rhs(k_mv, rhs_f, free, bc_values)
            x, info = gmres(AA, layout.concat((b0, rhs_g)), prec,
                            tol=cfg.schur.tolerance,
                            reduction=cfg.schur.reduction,
                            max_steps=cfg.schur.max_steps,
                            restart=cfg.fgmres_restart, stats=self.stats)
            u, lam = layout.split(x)
            return torch.where(free, u, bc_values), lam, info

        return run

    def _build_rational(self):
        """MINRES + rational preconditioner diag(K⁻¹, (−Δ_Γ)^{-1/2})
        (immersed_laplace.cc:585-635).  In float32 the outer is FGMRES: the
        preconditioner's inner solves stop on tolerances, so it varies
        between outer iterations and MINRES, which assumes a fixed SPD
        preconditioner, stagnates (the JAX package measured 1000 iterations
        at refinement 5 against 22 for FGMRES)."""
        cfg = self.cfg
        K_c, K_inv = self._kg_inv()
        C_lin = self.C.as_linop()
        Ct_lin = C_lin.T
        layout = self.layout
        free = self.free
        k_mv = self._k_mv()
        # ρ bound: ℓ∞ norm of A_Γ over the smallest diagonal of M (:609-614)
        rho_bound = (self._imm_linfty_norm(self.A_imm)
                     / float(self.M.diag().min()))
        prec = rational_preconditioner(layout, K_inv, self.A_imm, self.M,
                                       rho_bound, stats=self.stats)
        AA = block_operator(layout, layout, [[K_c, Ct_lin], [C_lin, None]])
        # restart truncation stalls the float32 FGMRES near its precision
        # floor, so keep a generous basis within ~2 GB, hard-capped at ~6 GB
        # for the V and Z bases (8 bytes a dof per basis vector)
        budget = min(200, int(2e9 / (4 * max(layout.total, 1))))
        hard_cap = max(8, int(6e9 / (8 * max(layout.total, 1))))
        restart = min(max(cfg.fgmres_restart, budget), hard_cap)
        f32 = self.dtype == torch.float32

        def run(rhs_f, rhs_g, bc_values):
            b0 = dirichlet_rhs(k_mv, rhs_f, free, bc_values)
            b = layout.concat((b0, rhs_g))
            ctl = dict(tol=cfg.schur.tolerance, reduction=cfg.schur.reduction,
                       max_steps=cfg.schur.max_steps, stats=self.stats)
            if f32:
                x, info = fgmres(AA, b, prec, restart=restart, **ctl)
            else:
                x, info = minres(AA, b, prec, **ctl)
            u, lam = layout.split(x)
            return torch.where(free, u, bc_values), lam, info

        return run

    @staticmethod
    def _imm_linfty_norm(A) -> float:
        rows, _, vals = A.to_coo()
        sums = np.zeros(A.shape[0])
        np.add.at(sums, rows, np.abs(vals))
        return float(sums.max())

    # -- diagnostics ----------------------------------------------------------

    def constraint_residual(self) -> float:
        """||C u - (g, ψ)||_inf: residual of the constraint block equation."""
        return float(torch.max(torch.abs(self.C.mv(self.u) - self.rhs_g)))
