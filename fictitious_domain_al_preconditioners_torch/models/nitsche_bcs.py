"""Dirichlet boundary conditions imposed weakly through a boundary Lagrange
multiplier ("Nitsche"-style), with AL-preconditioned FGMRES.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.models.nitsche_bcs``
(the reference's ``nitsche_bcs`` executable, nitsche_bcs.cc, class
``NitscheLagrangeProblem``):

    -Δu + u = f in Ω,  u = g on ∂Ω (weakly):
    [ K + M + γ(1/h)Σφφᵀ   Cᵀ ] [u]   [f + γ(1/h)(g, φ)_∂Ω]
    [ C                    0  ] [λ] = [(g, μ)]

The multiplier lives on the boundary mesh of the bulk grid itself
(extract_boundary_mesh, nitsche_bcs.cc:265-267), so the coupling is the
generic quad-point table with exact point location.  There are no strong
Dirichlet rows: every GMG level is all free.

The outer FGMRES, the inner CG on the augmented bulk block, W⁻¹ =
(1/h)·M⁻¹ and the operator run in float64; the flat GMG V-cycle
(:func:`..precond.gmg.build_gmg_flat`, level operator K_l + M_l + γ/h·the
particle mass of the level's coupling) runs in the problem's ``dtype``.
Every apply is element form (``CellMatrix.mv``) or the coupling's gathers
and ``index_add_``, as in the reference package, whose nitsche path reaches
no Pallas kernel: no kernel of this repo is on this path.

Reports the reference's metrics: outer FGMRES iterations, the total of
inner CG iterations and inner CG per outer (nitsche_bcs.cc:652-667), and
the manufactured-solution study (u = sin(πx)sin(πy)).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.generators import background_grid_from_name
from ..core.grid import GridSpace
from ..core.immersed import boundary_mesh
from ..ops.assembly import (h1_error, imm_mass_matrix, imm_rhs, l2_error,
                            laplace_matrix, mass_matrix, rhs_vector)
from ..ops.blocks import BlockLayout, block_operator
from ..ops.coupling import build_coupling
from ..ops.host_ref import HostNitscheSystem
from ..ops.krylov import fgmres
from ..ops.linop import LinOp
from ..ops.operators import CellMatrix
from ..precond.al import al_preconditioner, block_solve
from ..precond.gmg import build_gmg_flat
from ..precond.weights import inv_exact
from ..utils.expressions import ParsedFunction
from ..utils.prm import Params, parse_prm
from ..utils.refine import CORRECTION_MAX_OUTER
from ..utils.report import ConvergenceTable
from ..utils.timer import TimerOutput
from .session import SolveSession, split_correction

__all__ = ["ControlConfig", "NitscheConfig", "NitscheProblem",
           "manufactured_solution", "manufactured_gradient",
           "manufactured_rhs"]


def manufactured_solution(p):
    p = np.asarray(p)
    return np.sin(np.pi * p[:, 0]) * np.sin(np.pi * p[:, 1])


def manufactured_gradient(p):
    p = np.asarray(p)
    gx = np.pi * np.cos(np.pi * p[:, 0]) * np.sin(np.pi * p[:, 1])
    gy = np.pi * np.sin(np.pi * p[:, 0]) * np.cos(np.pi * p[:, 1])
    return np.stack([gx, gy], axis=1)


def manufactured_rhs(p):
    """-Δu + u of the manufactured solution (nitsche_bcs.cc:81-89)."""
    p = np.asarray(p)
    return ((2.0 * np.pi ** 2 + 1.0) * np.sin(np.pi * p[:, 0])
            * np.sin(np.pi * p[:, 1]))


@dataclass
class ControlConfig:
    max_steps: int = 1000
    tolerance: float = 1e-8
    reduction: float | None = None


@dataclass
class NitscheConfig:
    """Mirror of the reference Parameters (nitsche_bcs.cc:101-242); field
    names and defaults as in the JAX package."""

    initial_refinement: int = 4
    n_refinement_cycles: int = 1
    name_of_grid: str = "hyper_cube"
    arguments_for_grid: str = "0.0: 1.0: true"
    bulk_space_degree: int = 1
    multiplier_degree: int = 1
    use_discontinuous_multiplier: bool = False
    coupling_quadrature_order: int = 3
    use_manufactured_solution: bool = False
    rhs: tuple = ("1", "")
    dirichlet_data: tuple = ("0", "")
    outer: ControlConfig = field(default_factory=ControlConfig)
    inner: ControlConfig = field(default_factory=lambda: ControlConfig(
        max_steps=1000, tolerance=1e-12, reduction=1e-2))
    gamma: float = 10.0  # hardcoded (nitsche_bcs.cc:513)
    fgmres_restart: int = 50

    @classmethod
    def from_prm(cls, text_or_path) -> "NitscheConfig":
        text = text_or_path
        if "\n" not in str(text_or_path):
            with open(text_or_path) as fh:
                text = fh.read()
        p = Params(parse_prm(text)).enter("Nitsche Lagrange<1,2>")

        def ctl(section, **d):
            s = p.enter(section)
            red = s.get_float("Reduction", d.get("reduction", 0.0))
            return ControlConfig(
                max_steps=s.get_int("Max steps", d.get("max_steps", 100)),
                tolerance=s.get_float("Tolerance", d.get("tolerance", 1e-10)),
                reduction=red if red > 0 else None)

        def fn(section, default):
            s = p.enter(section)
            return (s.get_str("Function expression", default),
                    s.get_str("Function constants", ""))

        return cls(
            initial_refinement=p.get_int("Initial space refinement", 4),
            n_refinement_cycles=p.get_int("Number of refinement cycles", 1),
            name_of_grid=p.get_str("Name of the grid", "hyper_cube"),
            arguments_for_grid=p.get_str("Arguments for the grid",
                                         "0.0: 1.0: true"),
            bulk_space_degree=p.get_int("Bulk space finite element degree",
                                        1),
            multiplier_degree=p.get_int("Multiplier finite element degree",
                                        1),
            use_discontinuous_multiplier=p.get_bool(
                "Use discontinuous multiplier space", False),
            coupling_quadrature_order=p.get_int("Coupling quadrature order",
                                                3),
            use_manufactured_solution=p.get_bool("Use manufactured solution",
                                                 False),
            rhs=fn("Right hand side", "1"),
            dirichlet_data=fn("Dirichlet boundary data", "0"),
            outer=ctl("Outer solver control", max_steps=1000, tolerance=1e-8),
            inner=ctl("Inner solver control", max_steps=1000, tolerance=1e-12,
                      reduction=1e-2),
        )


class NitscheProblem:
    """``NitscheProblem(cfg).setup(cycle)`` then ``.solve()`` or
    ``.solve_refined()``.  The problem runs on the CUDA card unless
    ``device="cpu"`` is given.

    ``dtype`` is the preconditioner's precision only: that of the bulk GMG
    V-cycle, float64 on the CPU and float32 on CUDA by default.  The
    problem's arrays, the 2x2 operator, the outer FGMRES, the inner CG,
    W⁻¹ and the solution are float64 whatever ``dtype`` is (the split the
    elliptic interface and Stokes problems keep).  ``lanczos_start``
    (optional attribute, ``(level_index, n) -> ndarray``) injects the
    Lanczos start vectors of the bulk hierarchy."""

    # the precision of the operator and of every Krylov solver
    OP_DTYPE = torch.float64

    def __init__(self, config: NitscheConfig, *, device="cuda", dtype=None):
        self.cfg = config
        self.device = torch.device(device)
        self.dtype = dtype or (torch.float64 if self.device.type == "cpu"
                               else torch.float32)
        self.timer = TimerOutput()
        self.table = ConvergenceTable()
        self.results = {}
        self.stats = {"host_syncs": 0, "inner_iterations": 0}
        self.lanczos_start = None
        self._parts = None
        self.session = SolveSession(self, "nitsche_bcs")

    # -- setup --------------------------------------------------------------

    def setup(self, cycle: int = 0):
        cfg = self.cfg
        dev, dt = self.device, self.OP_DTYPE
        t0 = time.perf_counter()
        with self.timer.scope("Setup grids and dofs"):
            self.grid = background_grid_from_name(
                cfg.name_of_grid, cfg.arguments_for_grid, 2,
                cfg.initial_refinement + cycle)
            self.space = GridSpace.q(self.grid, cfg.bulk_space_degree)
            self.bmesh = boundary_mesh(self.grid)
            self.mult_space = self.bmesh.space(
                cfg.multiplier_degree,
                continuous=not cfg.use_discontinuous_multiplier)

        deg = cfg.bulk_space_degree
        # one shared boundary quadrature (nitsche_bcs.cc:404-407)
        self.boundary_q = max(2 * deg + 1,
                              2 * max(cfg.multiplier_degree, 1) + 1,
                              cfg.coupling_quadrature_order)
        with self.timer.scope("Assemble system"):
            # K = (grad u, grad v) + (u, v): no strong Dirichlet rows
            self.K = laplace_matrix(self.space, order=deg + 1, device=dev,
                                    dtype=dt)
            self.Mbulk = mass_matrix(self.space, order=deg + 1, device=dev,
                                     dtype=dt)
            if cfg.use_manufactured_solution:
                self.f_fn = manufactured_rhs
                self.g_fn = lambda p: np.zeros(np.asarray(p).shape[0])
            else:
                self.f_fn = ParsedFunction(*cfg.rhs)
                self.g_fn = ParsedFunction(*cfg.dirichlet_data)
            self.rhs_f = rhs_vector(self.space, self.f_fn, order=deg + 1,
                                    device=dev, dtype=dt)
            self.M = imm_mass_matrix(self.mult_space, order=self.boundary_q,
                                     device=dev, dtype=dt)
            self.rhs_g = imm_rhs(self.mult_space, self.g_fn,
                                 order=self.boundary_q, device=dev, dtype=dt)
        with self.timer.scope("Setup coupling"):
            self.C = build_coupling(self.space, self.mult_space,
                                    order=self.boundary_q, device=dev,
                                    dtype=dt)
        # sum(C) == |∂Ω| (nitsche_bcs.cc:467-490, the reference's DEBUG
        # check)
        measure = self.bmesh.measure
        if abs(self.C.sum() - measure) >= 1e-10 * max(measure, 1.0):
            raise ValueError("the coupling matrix's sum does not match the "
                             "boundary measure")
        self.layout = BlockLayout((self.space.n_dofs,
                                   self.mult_space.n_dofs))
        self._parts = None
        self.session.reset()
        self.results["setup_seconds"] = time.perf_counter() - t0
        return self

    def load_state(self, state):
        """Replace the setup arrays by carried ones (see
        :func:`..utils.carry.state_from_jax`): the right-hand sides, the
        coupling table, the multiplier mass and the Lanczos start vectors of
        the bulk hierarchy.  The solver is rebuilt at the next solve."""
        self.rhs_f, self.rhs_g = state.rhs_f, state.rhs_g
        self.C, self.M = state.coupling, state.M
        if state.lanczos_starts is not None:
            self.lanczos_start = (lambda i, n, s=state.lanczos_starts: s[i])
        self._parts = None
        self.session.reset()
        return self

    # -- the solver -----------------------------------------------------------

    def _bulk_matrix(self, sp, dtype) -> CellMatrix:
        """K + M of a level space as one element-form matrix (one shared
        local matrix: the sum of the stiffness's and the mass's)."""
        order = self.cfg.bulk_space_degree + 1
        K = laplace_matrix(sp, order=order, device="cpu")
        M = mass_matrix(sp, order=order, device="cpu")
        return CellMatrix(sp.cell_dofs, sp.cell_dofs,
                          K.local_host + M.local_host, K.shape,
                          device=self.device, dtype=dtype)

    def _aug_rhs(self):
        """The consistent augmentation γ(1/h)(g, φ_i)_∂Ω of the bulk
        right-hand side (nitsche_bcs.cc:588-632), from the quad-point table
        (float64 on the host)."""
        h = self.C.host
        g_q = np.asarray(self.g_fn(self.C.points), dtype=np.float64)
        out = np.zeros(self.space.n_dofs)
        np.add.at(out, h["bg_dofs"], h["bg_phi"] * (g_q * h["jxw"])[:, None])
        return self.cfg.gamma / self.bmesh.h_max * out

    def _solver_parts(self):
        """The 2x2 operator and the counting AL preconditioner, built once a
        setup (:meth:`solve` and the correction solves of
        :meth:`solve_refined` run on them)."""
        if self._parts is not None:
            return self._parts
        cfg = self.cfg
        dev, op_dt, dt = self.device, self.OP_DTYPE, self.dtype
        layout = self.layout
        gamma = cfg.gamma
        gal = gamma / self.bmesh.h_max
        KM = self._bulk_matrix(self.space, op_dt)
        # the particle AL term γ(1/h)Σφφᵀ (nitsche_bcs.cc:515-572)
        AL = self.C.particle_mass_term(gal)
        al_diag = self.C.particle_mass_diag(gal)

        def aug_mv(x):
            return KM.mv(x) + AL(x)

        def factory(sp):
            A_l = (KM.astype(dt) if sp is self.space
                   else self._bulk_matrix(sp, dt))
            Cl = (self.C if sp is self.space else build_coupling(
                sp, self.mult_space, order=self.boundary_q, device="cpu"))
            al_l = Cl.to(dev, dt).particle_mass_term(gal)

            def mv(x):
                return A_l.mv(x) + al_l(x)

            return mv, A_l.diag_host() + Cl.particle_mass_diag(gal)

        gmg = build_gmg_flat(
            self.space, factory,
            free_mask=torch.ones(self.space.n_dofs, dtype=torch.bool,
                                 device=dev),
            lanczos_start=self.lanczos_start, dtype=dt, stats=self.stats)
        # W⁻¹ = (1/h)·M⁻¹
        inv_w = inv_exact(self.M, scale=1.0 / self.bmesh.h_max)
        C_lin = self.C.as_linop()
        Ct_lin = C_lin.T
        AA = block_operator(layout, layout, [
            [LinOp(aug_mv, (layout.sizes[0],) * 2), Ct_lin], [C_lin, None]])

        def aug_inv(v):
            x, _ = block_solve(aug_mv, v, M=gmg.apply,
                               tol=cfg.inner.tolerance,
                               reduction=cfg.inner.reduction,
                               max_steps=cfg.inner.max_steps, stats=self.stats)
            return x

        prec = al_preconditioner(layout, aug_inv, Ct_lin, inv_w, gamma)
        self._parts = dict(system_operator=AA, prec=prec, gmg=gmg,
                           aug_rhs=torch.as_tensor(self._aug_rhs(),
                                                   dtype=op_dt, device=dev))
        return self._parts

    def _build_solver(self, raw_rhs: bool = False,
                      max_steps: int | None = None):
        """``run(rhs_f, rhs_g) -> (x, info, inner_total)``; with ``raw_rhs``
        ``run_raw(r0, r1) -> (x, info, inner_total)`` for an assembled block
        right-hand side (the correction solve of :meth:`solve_refined`).
        ``max_steps`` caps the outer steps (default ``cfg.outer.max_steps``).
        """
        cfg = self.cfg
        layout = self.layout
        parts = self._solver_parts()
        if max_steps is None:
            max_steps = cfg.outer.max_steps

        def solve_core(b):
            # the reference's total of inner CG iterations
            # (nitsche_bcs.cc:652-667), summed over one outer solve
            before = self.stats["inner_iterations"]
            x, info = fgmres(parts["system_operator"], b, parts["prec"],
                             tol=cfg.outer.tolerance,
                             reduction=cfg.outer.reduction,
                             max_steps=max_steps, restart=cfg.fgmres_restart,
                             stats=self.stats)
            return x, info, self.stats["inner_iterations"] - before

        if raw_rhs:
            def run_raw(r0, r1):
                return solve_core(layout.concat((r0, r1)))

            return run_raw

        def run(rhs_f, rhs_g):
            return solve_core(layout.concat((rhs_f + parts["aug_rhs"],
                                             rhs_g)))

        return run

    # -- solve ----------------------------------------------------------------

    def solve(self) -> int:
        """Build the solver (once a setup) and run it; returns the outer
        iterations.  ``results`` records them with the inner CG total and
        per outer iteration (also as ``inner_iterations``), convergence,
        the solve and build seconds and the host syncs."""
        x, info, inner_total = self.session.solve(
            "dlm", "dlm", self._build_solver, self.rhs_f, self.rhs_g)
        self.u, self.lam = self.layout.split(x)
        outer = int(info.iterations)
        self.results.update(
            dofs_u=self.space.n_dofs, dofs_lambda=self.mult_space.n_dofs,
            outer_its=outer, inner_cg_total=int(inner_total),
            inner_cg_per_outer=float(inner_total) / max(outer, 1),
            converged=bool(info.converged), residual=float(info.residual))
        return outer

    def build_correction_solver(self):
        """``(r0, r1) -> (x, info, inner_total)``: one AL-preconditioned
        FGMRES solve with a raw right-hand side, its outer steps capped at
        ``utils.refine.CORRECTION_MAX_OUTER`` (the inner engine of
        :meth:`solve_refined`)."""
        return self._build_solver(
            raw_rhs=True,
            max_steps=min(self.cfg.outer.max_steps, CORRECTION_MAX_OUTER))

    def solve_refined(self, tol_abs: float = 1e-10, max_refine: int = 12):
        """Iterative refinement to the reference's solve quality: correction
        solves on the device (float64 Krylov solvers on a V-cycle in
        ``dtype``), the true float64 residual of the 2x2 system on the host
        (:class:`..ops.host_ref.HostNitscheSystem`), looped to ``tol_abs``
        under the guard of :func:`..utils.refine.guarded_refinement`.

        Returns ``(u, lam, history)``: float64 NumPy iterates and the
        accepted true residual norms.  ``results`` records the total outer
        and inner CG iterations, the final residual, the accepted steps,
        convergence, the seconds of the loop, of the device corrections and
        of the host residuals, and the host syncs
        (:meth:`.session.SolveSession.refine`, its ``outer_iterations`` as
        ``outer_its``).  The host system and the correction solver are built
        once per :meth:`setup`."""
        (u, lam), history = self.session.refine(
            HostNitscheSystem,
            lambda: split_correction(self.layout,
                                     self.build_correction_solver()),
            self.layout.sizes, self.OP_DTYPE, ("u", "lam"), tol_abs,
            max_refine)
        res = self.results
        total_outer = res.pop("outer_iterations")
        # every inner CG iteration of the loop is one of a correction's
        inner_total = res["inner_iterations"]
        res.update(
            dofs_u=self.space.n_dofs, dofs_lambda=self.mult_space.n_dofs,
            outer_its=total_outer, inner_cg_total=inner_total,
            inner_cg_per_outer=float(inner_total) / max(total_outer, 1))
        return u, lam, history

    # -- diagnostics --------------------------------------------------------

    def errors(self):
        """L2 and H1-seminorm errors against the manufactured solution."""
        return (l2_error(self.space, self.u, manufactured_solution),
                h1_error(self.space, self.u, manufactured_gradient))

    def run(self):
        """The refinement-cycle study: one solve a cycle, a row each in
        ``table`` (with the L2/H1 errors and their rates for the
        manufactured solution)."""
        cfg = self.cfg
        for cycle in range(cfg.n_refinement_cycles):
            self.setup(cycle)
            self.solve()
            res = self.results
            row = dict(cells=self.grid.n_cells, dofs_u=res["dofs_u"],
                       dofs_lambda=res["dofs_lambda"],
                       outer_its=res["outer_its"],
                       inner_cg_total=res["inner_cg_total"],
                       h=self.grid.cell_diameter)
            row["inner_cg/outer"] = round(res["inner_cg_per_outer"], 1)
            if cfg.use_manufactured_solution:
                row["L2_u"], row["H1_u"] = self.errors()
            self.table.add_row(**row)
        if cfg.use_manufactured_solution:
            self.table.evaluate_rates(["L2_u", "H1_u"])
        return self.table
