"""Stokes flow with an immersed boundary (2D closed curve, 3D sphere surface).

Counterpart of ``fictitious_domain_al_preconditioners_tpu.models.stokes``
(the reference's ``stokes_immersed_boundary`` executable,
stokes_immersed_boundary.cc, class ``IBStokesProblem``):

    [ A   Bᵀ  Cᵀ ] [u]   [f]        A: (∇u:∇v) + γ_gd(div u, div v)  (grad-div)
    [ B   0   0  ] [p] = [0]           or 2(ε(u):ε(v))
    [ C   0   0  ] [λ]   [g]        C: velocity ↔ vector multiplier on Γ

Velocity Q2 vector (component-major flat vectors) and pressure Q1
(Taylor-Hood) or P1disc (Q2-P1disc, stokes_immersed_boundary.cc:517-529),
vector multiplier FE_Q(k) or FE_DGQ(0) on the immersed mesh.  Solvers
(stokes_immersed_boundary.cc:826-1074):

- ``Stokes``: the step-22 Schur-complement CG baseline (no immersed body);
- ``IBStokes``: nested exact Schur complements, no preconditioner;
- ``IBStokesAL``: FGMRES with the 3x3 AL preconditioner, or MinRes with its
  SPD diagonal variant; the augmented block Aug = A + γCᵀW⁻¹C
  (+ γ_gd BᵀMp⁻¹B without grad-div) is inverted by CG in diagonally scaled
  variables on a vector GMG V-cycle.

The reference's AMG on the augmented velocity block is a flat vector GMG
(:func:`..precond.gmg.build_gmg_flat`) whose levels re-discretize the AL
term: on each level the whole matrix A_l + γ·blockdiag(Cᵀdiag(w)C) is one
band stencil (:func:`..ops.sparse_band.lattice_band_linop`) or, where the
band would need more weight planes (3D Q2) or a wider band (the AL term of
a fine 2D level) than it allows, the element-form A_l and the coupling
applies.  No kernel of this repo is
on this path: every apply is PyTorch (gathers, ``index_add_``, the band's
strided products).

With ``delta_refinement > 0`` the background is a 2:1-balanced quadtree or
octree refined near the multiplier's support points (``core.adaptive``,
stokes_immersed_boundary.cc:468-483), the velocity a folded Q2 space, the
pressure a folded Q1 or the cellwise P1disc space on the same tree; A, B
and Mp are element form (:func:`..ops.assembly.adaptive_matrix`) and every
GMG level takes the element route, the tree coarsening by truncation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.adaptive import AdaptiveDGPSpace, AdaptiveGrid, AdaptiveSpace
from ..core.grid import GridSpace, UniformGrid
from ..core.immersed import hyper_sphere, parametrized_curve
from ..ops.assembly import (adaptive_mixed_cell_matrix,
                            adaptive_vector_cell_matrix,
                            divergence_block_local, imm_mass_matrix, imm_rhs,
                            mass_matrix, rhs_vector, vector_cell_dofs,
                            velocity_block_local)
from ..ops.blocks import BlockLayout, block_operator
from ..ops.coupling import VectorCoupling, build_coupling
from ..ops.host_ref import HostStokesSystem
from ..ops.krylov import cg, fgmres, minres
from ..ops.linop import LinOp
from ..ops.operators import CellMatrix, constrain, dirichlet_rhs
from ..ops.sparse_band import vector_al_level
from ..precond.al import (al_preconditioner_diagonal, al_preconditioner_stokes,
                          block_solve)
from ..precond.gmg import build_gmg_flat
from ..utils.expressions import ParsedFunction
from ..utils.prm import Params, parse_prm
from ..utils.refine import CORRECTION_MAX_OUTER
from ..utils.timer import TimerOutput
from .session import SolveSession, split_correction

__all__ = ["ALControl", "OuterControl", "StokesConfig", "StokesProblem"]

SOLVERS = ("Stokes", "IBStokes", "IBStokesAL")


@dataclass
class ALControl:
    """Mirror of ``ALControl`` (stokes_immersed_boundary.cc:152-190)."""

    gamma: float = 10.0
    gamma_grad_div: float = 10.0
    grad_div_stabilization: bool = True
    inverse_diag_square: bool = False  # "Diagonal mass immersed"
    amg_for_augmented: bool = True     # "AMG for augmented block"
    diagonal_spd_prec: bool = False
    max_iterations: int = 100
    tolerance: float = 1e-2


@dataclass
class OuterControl:
    max_steps: int = 1000
    tolerance: float = 1e-8
    reduction: float | None = 1e-12


@dataclass
class StokesConfig:
    """Mirror of the Parameters class (stokes_immersed_boundary.cc:194-351);
    field names and defaults as in the JAX package."""

    spacedim: int = 2
    initial_refinement: int = 4
    initial_embedded_refinement: int = 5
    delta_refinement: int = 0
    dirichlet_ids: tuple = (0, 1, 2, 3)
    embedded_configuration_degree: int = 1
    embedded_space_degree: int = 1
    velocity_degree: int = 2
    use_disc_pressure: bool = False
    solver: str = "IBStokesAL"
    al: ALControl = field(default_factory=ALControl)
    outer: OuterControl = field(default_factory=OuterControl)
    embedded_configuration: tuple = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                     "R=.21, Cx=.45,Cy=.45")
    embedded_value: tuple = ("-.5;.5", "")
    dirichlet_bc: tuple = ("0;0;0", "")
    body_force: tuple = ("1;1", "")
    fgmres_restart: int = 50

    @classmethod
    def from_prm(cls, text_or_path, spacedim: int = 2) -> "StokesConfig":
        text = text_or_path
        if "\n" not in str(text_or_path):
            with open(text_or_path) as fh:
                text = fh.read()
        dim = spacedim - 1
        p = Params(parse_prm(text)).enter(
            f"Distributed Lagrange<{dim},{spacedim}>")
        alp = p.enter("Augmented Lagrangian control")
        oc = p.enter("Outer solver control")

        def fn(section, default):
            s = p.enter(section)
            return (s.get_str("Function expression", default),
                    s.get_str("Function constants", ""))

        red = oc.get_float("Reduction", 1e-12)
        return cls(
            spacedim=spacedim,
            initial_refinement=p.get_int("Initial background space refinement", 4),
            initial_embedded_refinement=p.get_int("Initial embedded space refinement", 5),
            delta_refinement=p.get_int("Local refinements steps near embedded domain", 0),
            dirichlet_ids=tuple(p.get_int_list("Dirichlet boundary ids",
                                               tuple(range(2 * spacedim)))),
            embedded_configuration_degree=p.get_int("Embedded configuration finite element degree", 1),
            embedded_space_degree=p.get_int("Embedded space finite element degree", 1),
            velocity_degree=p.get_int("Velocity space finite element degree", 2),
            use_disc_pressure=p.get_bool("Use discontinuous pressure", False),
            solver=p.get_str("Solver", "IBStokesAL"),
            al=ALControl(
                gamma=alp.get_float("Gamma", 10.0),
                gamma_grad_div=alp.get_float("Gamma Grad-div", 10.0),
                grad_div_stabilization=alp.get_bool("Grad-div stabilization", True),
                inverse_diag_square=alp.get_bool("Diagonal mass immersed", False),
                amg_for_augmented=alp.get_bool("AMG for augmented block", True),
                diagonal_spd_prec=alp.get_bool("Diagonal SPD preconditioner", False),
                max_iterations=alp.get_int("Max steps", 100),
                tolerance=alp.get_float("Tolerance for Augmented Lagrangian", 1e-2)),
            outer=OuterControl(max_steps=oc.get_int("Max steps", 1000),
                               tolerance=oc.get_float("Tolerance", 1e-8),
                               reduction=red if red > 0 else None),
            embedded_configuration=fn("Embedded configuration",
                                      "R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy"),
            embedded_value=fn("Embedded value", "-.5;.5"),
            dirichlet_bc=fn("Dirichlet boundary condition",
                            ";".join(["0"] * (spacedim + 1))),
            body_force=fn("Body force", ";".join(["1"] * spacedim)),
        )


class StokesProblem:
    """``StokesProblem(cfg).setup()`` then ``.solve()`` or
    ``.solve_refined()``.  The problem runs on the CUDA card unless
    ``device="cpu"`` is given.

    ``dtype`` is the preconditioner's precision only: that of the velocity
    GMG V-cycle (its level operators, transfers and smoothers), float64 on
    the CPU and float32 on CUDA by default.  The problem's arrays, the 3x3
    operator, the outer FGMRES or MinRes, the inner CG on the augmented
    block, Mp⁻¹, W⁻¹ and the solution are float64 whatever ``dtype`` is
    (see :meth:`_al_parts`).  ``lanczos_start`` (optional attribute,
    ``(level_index, n) -> ndarray``) injects the Lanczos start vectors of the
    velocity hierarchy (``n = spacedim·n_level``)."""

    # the precision of the operator and of every Krylov solver
    OP_DTYPE = torch.float64

    def __init__(self, config: StokesConfig, *, device="cuda", dtype=None):
        self.cfg = config
        self.device = torch.device(device)
        self.dtype = dtype or (torch.float64 if self.device.type == "cpu"
                               else torch.float32)
        self.timer = TimerOutput()
        self.results = {}
        self.stats = {"host_syncs": 0, "inner_iterations": 0}
        self.lanczos_start = None
        self._parts = None
        self.session = SolveSession(self, "stokes")

    def _check_supported(self):
        cfg = self.cfg
        if cfg.solver not in SOLVERS:
            raise ValueError(f"unknown solver {cfg.solver!r}; one of "
                             f"{SOLVERS}")

    # -- setup --------------------------------------------------------------

    def setup(self):
        self._check_supported()
        cfg = self.cfg
        sd = cfg.spacedim
        dev, dt = self.device, self.OP_DTYPE
        t0 = time.perf_counter()
        with self.timer.scope("Setup grids and dofs"):
            if sd == 2:
                conf = ParsedFunction(*cfg.embedded_configuration)

                def conf_fn(pts):
                    return np.asarray(conf(pts))

                self.imm_mesh = parametrized_curve(
                    conf_fn, cfg.initial_embedded_refinement,
                    geom_degree=cfg.embedded_configuration_degree)
            else:
                # 3D: sphere of radius 0.1 at the cube's center
                # (stokes_immersed_boundary.cc:427)
                self.imm_mesh = hyper_sphere([0.5, 0.5, 0.5], 0.1,
                                             cfg.initial_embedded_refinement)
            # background unit cube, colorized (stokes_immersed_boundary.cc:417);
            # delta_refinement refines near the multiplier's support points
            # whatever the pressure space (:468-483, 517-529)
            if cfg.use_disc_pressure:
                assert cfg.velocity_degree == 2, "not a stable pair!"
            if cfg.delta_refinement > 0:
                grid = AdaptiveGrid.uniform(sd, cfg.initial_refinement)
                support = self.imm_mesh.space(
                    max(cfg.embedded_space_degree, 1)).dof_points
                for _ in range(cfg.delta_refinement):
                    grid = grid.refine_near(support)
                self.grid = grid
                self.vel_space = AdaptiveSpace(grid, cfg.velocity_degree)
                self.p_space = (AdaptiveDGPSpace(grid, 1)
                                if cfg.use_disc_pressure else
                                AdaptiveSpace(grid, cfg.velocity_degree - 1))
                h_min_diam = grid.min_cell_diameter
            else:
                self.grid = UniformGrid.hyper_cube(sd, 0.0, 1.0,
                                                   cfg.initial_refinement)
                self.vel_space = GridSpace.q(self.grid, cfg.velocity_degree)
                self.p_space = (GridSpace.dgp(self.grid, 1)
                                if cfg.use_disc_pressure else
                                GridSpace.q(self.grid,
                                            cfg.velocity_degree - 1))
                h_min_diam = self.grid.cell_diameter
            if sd == 2 and self.imm_mesh.h_max >= h_min_diam:
                raise ValueError("mesh-size compatibility violated "
                                 "(stokes_immersed_boundary.cc:497-503)")
            self.mult_space = self.imm_mesh.space(
                max(cfg.embedded_space_degree, 0),
                continuous=cfg.embedded_space_degree > 0)

        nu = self.vel_space.n_dofs
        with self.timer.scope("Assemble Stokes"):
            order = cfg.velocity_degree + 2
            self.A = self._vel_block(self.vel_space, dt)
            self.B = self._div_block()
            self.Mp = mass_matrix(self.p_space, order=order, device=dev,
                                  dtype=dt)
            bf = ParsedFunction(*cfg.body_force)
            f_vec = rhs_vector(self.vel_space, bf, order=order, device=dev,
                               dtype=dt)                   # (nu, sd)
            self.rhs_u = f_vec.T.reshape(-1)                # component-major
            bc = ParsedFunction(*cfg.dirichlet_bc)
            bc_pts = np.asarray(bc(self.vel_space.dof_points))[:, :sd]
            self.bc_values = torch.as_tensor(bc_pts.T.reshape(-1), dtype=dt,
                                             device=dev)
            free_scalar = ~self.vel_space.boundary_dof_mask(
                list(cfg.dirichlet_ids))
            self.free = torch.as_tensor(np.tile(free_scalar, sd), device=dev)

        with self.timer.scope("Assemble coupling"):
            self.Cs = build_coupling(self.vel_space, self.mult_space,
                                     self._coupling_order(), device=dev,
                                     dtype=dt)
            self.C = VectorCoupling(self.Cs, sd)
            self.M_imm_s = imm_mass_matrix(
                self.mult_space,
                order=2 * max(cfg.embedded_space_degree, 1) + 1, device=dev,
                dtype=dt)
            g_fn = ParsedFunction(*cfg.embedded_value)
            g_vec = imm_rhs(self.mult_space, g_fn,
                            order=self._coupling_order(), device=dev,
                            dtype=dt)                      # (n_imm, sd)
            self.rhs_g = g_vec.T.reshape(-1)

        self.layout = BlockLayout((nu * sd, self.p_space.n_dofs,
                                   self.mult_space.n_dofs * sd))
        self._parts = None
        self.session.reset()
        self.results["setup_seconds"] = time.perf_counter() - t0
        return self

    def load_state(self, state):
        """Replace the setup arrays by carried ones (see
        :func:`..utils.carry.state_from_jax`): right-hand sides, Dirichlet
        data and mask, the scalar coupling table, the immersed and pressure
        mass matrices and the Lanczos start vectors of the velocity
        hierarchy.  The solver is rebuilt at the next solve."""
        self.rhs_u, self.rhs_g = state.rhs_u, state.rhs_g
        self.bc_values, self.free = state.bc_values, state.free
        self.Cs = state.coupling
        self.C = VectorCoupling(self.Cs, self.cfg.spacedim)
        self.M_imm_s, self.Mp = state.M_imm, state.Mp
        if state.lanczos_starts is not None:
            self.lanczos_start = (lambda i, n, s=state.lanczos_starts: s[i])
        self._parts = None
        self.session.reset()
        return self

    # -- blocks ---------------------------------------------------------------

    def _coupling_order(self) -> int:
        return 2 * max(self.cfg.embedded_space_degree, 1) + 2

    def _gd_coef(self):
        al = self.cfg.al
        return al.gamma_grad_div if al.grad_div_stabilization else None

    def _vel_local(self, sp, h=None) -> np.ndarray:
        return velocity_block_local(sp.fe, sp.grid.h if h is None else h,
                                    self.cfg.velocity_degree + 2,
                                    self._gd_coef())

    def _vel_block(self, sp, dtype) -> CellMatrix:
        """The velocity block (grad-div-stabilized or symmetric gradient) on
        a level space: one shared local matrix, or on a tree one a level
        and the folded ones of the constrained cells."""
        sd = self.cfg.spacedim
        if hasattr(sp, "fold_of"):
            return adaptive_vector_cell_matrix(
                sp, lambda h: self._vel_local(sp, h), sd, device=self.device,
                dtype=dtype)
        vdofs = vector_cell_dofs(sp, sd)
        n = sp.n_dofs
        return CellMatrix(vdofs, vdofs, self._vel_local(sp),
                          (n * sd, n * sd), device=self.device, dtype=dtype)

    def _div_block(self) -> CellMatrix:
        """B = -(div u, q) on the background pair."""
        sd = self.cfg.spacedim
        order = self.cfg.velocity_degree + 2
        if hasattr(self.vel_space, "fold_of"):
            return adaptive_mixed_cell_matrix(
                self.p_space, self.vel_space,
                lambda h: divergence_block_local(self.p_space.fe,
                                                 self.vel_space.fe, h, order),
                sd, device=self.device, dtype=self.OP_DTYPE)
        b_local = divergence_block_local(self.p_space.fe, self.vel_space.fe,
                                         self.grid.h, order)
        return CellMatrix(self.p_space.cell_dofs,
                          vector_cell_dofs(self.vel_space, sd), b_local,
                          (self.p_space.n_dofs, self.vel_space.n_dofs * sd),
                          device=self.device, dtype=self.OP_DTYPE)

    def _condensed(self, op: LinOp) -> LinOp:
        """Zero the constrained-velocity columns of a rectangular operator
        acting on the velocity (the reference assembles B and C with the
        constraints: stokes_immersed_boundary.cc:574-581, 782)."""
        free = self.free

        def mv(x):
            return op(torch.where(free, x, 0.0))

        def rmv(y):
            return torch.where(free, op.T(y), 0.0)

        return LinOp(mv, op.shape, rmv)

    def _mp_inv(self):
        """Mp⁻¹: lumped-mass-preconditioned CG(100, 1e-6), or a tight CG in
        place of UMFPACK (stokes_immersed_boundary.cc:946-963)."""
        Mp = self.Mp
        lump = 1.0 / Mp.row_sums()
        if self.cfg.al.inverse_diag_square:
            kw = dict(tol=1e-6, max_steps=100)
        else:
            kw = dict(tol=0.0, reduction=1e-14, max_steps=1000)

        def mp_inv(v):
            x, _ = cg(Mp.mv, v, M=lambda r: lump * r, stats=self.stats, **kw)
            return x

        return mp_inv

    def _inv_w(self):
        """W⁻¹ on the vector multiplier space, diag(M)⁻² or (M⁻¹)²
        (stokes_immersed_boundary.cc:965-985), and the scalar diagonal
        weights of the GMG levels' AL term (float64 NumPy)."""
        sd = self.cfg.spacedim
        M = self.M_imm_s
        n = M.shape[0]
        d_host = M.diag_host()
        w_diag_scalar = 1.0 / d_host ** 2
        d = torch.as_tensor(d_host, dtype=self.OP_DTYPE, device=self.device)
        if self.cfg.al.inverse_diag_square:
            dinv2 = 1.0 / d ** 2

            def inv_w(lam):
                return (dinv2 * lam.reshape(sd, n)).reshape(-1)
        else:
            dinv = (1.0 / d)[:, None]

            def m_inv_scalar(v):
                x, _ = cg(M.mv, v, M=lambda r: dinv * r, tol=0.0,
                          reduction=1e-14, max_steps=1000, stats=self.stats)
                return x

            def inv_w(lam):
                v = lam.reshape(sd, n).T
                return m_inv_scalar(m_inv_scalar(v)).T.reshape(-1)

        return inv_w, w_diag_scalar

    # -- the velocity GMG -------------------------------------------------------

    def _gmg_velocity(self, with_al: bool, gamma: float, w_diag_scalar):
        """Vector GMG on the (augmented) velocity block, in ``self.dtype``
        (the build_AMG_augmented_block replacement, utilities.h:111-331).
        Each level's A_l + γ·blockdiag(Cᵀdiag(w)C) is one band stencil
        where the band takes it, else the element-form A_l plus the
        coupling applies; ``results["gmg_routes"]`` records which, fine
        level first."""
        cfg = self.cfg
        sd = cfg.spacedim
        dev, dt = self.device, self.dtype
        routes = []

        def factory(sp):
            A_l = (self.A.astype(dt) if sp is self.vel_space
                   else self._vel_block(sp, dt))
            Cl = None
            if with_al:
                Cl = (self.Cs if sp is self.vel_space else build_coupling(
                    sp, self.mult_space, self._coupling_order(),
                    device="cpu"))
            local = None if hasattr(sp, "fold_of") else self._vel_local(sp)
            mv, diag, route = vector_al_level(
                sp, A_l, local, sd, Cl, w_diag_scalar, gamma, device=dev,
                dtype=dt)
            routes.append(route)
            return mv, diag

        gmg = build_gmg_flat(self.vel_space, factory, free_mask=self.free,
                             n_comp=sd, lanczos_start=self.lanczos_start,
                             dtype=dt, stats=self.stats)
        self.results["gmg_routes"] = routes
        return gmg

    # -- solvers --------------------------------------------------------------

    def _blocks(self):
        """The condensed float64 blocks: constrained A, B, Bᵀ, C, Cᵀ."""
        B_lin = self._condensed(LinOp(self.B.mv, self.B.shape, self.B.rmv))
        C_lin = self._condensed(self.C.as_linop())
        return (constrain(self.A.as_linop(), self.free), B_lin, B_lin.T,
                C_lin, C_lin.T)

    def _al_parts(self):
        """The IBStokesAL 3x3 operator and its AL preconditioner, built once
        a setup (:meth:`solve` and the correction solves of
        :meth:`solve_refined` run on them).

        The 3x3 operator, the inner CG, Mp⁻¹ and W⁻¹ run in float64; only
        the V-cycle runs in ``self.dtype`` (float32 on CUDA), cast at its
        boundary.  The elliptic interface slice measured that a float32
        operator or Krylov solver loses the true residual at the reference's
        scale while float32 V-cycles keep the float64 counts."""
        if self._parts is not None:
            return self._parts
        cfg = self.cfg
        layout = self.layout
        gamma, gamma_gd = cfg.al.gamma, cfg.al.gamma_grad_div
        free = self.free
        dev, dt = self.device, self.OP_DTYPE
        A_lin, B_lin, Bt_lin, C_lin, Ct_lin = self._blocks()
        mp_inv = self._mp_inv()
        inv_w, w_diag_scalar = self._inv_w()

        if cfg.al.grad_div_stabilization:
            def aug_mv(x):
                return A_lin(x) + gamma * Ct_lin(inv_w(C_lin(x)))
        else:
            def aug_mv(x):
                return (A_lin(x) + gamma * Ct_lin(inv_w(C_lin(x)))
                        + gamma_gd * Bt_lin(mp_inv(B_lin(x))))

        gmg = self._gmg_velocity(True, gamma, w_diag_scalar)

        # The inner CG runs in symmetrically diagonally scaled variables
        # (D^-1/2 Aug D^-1/2): the AL term's diagonal on the Γ-band scales
        # like γ/diag(M_Γ)² against the O(1) viscous block.  In exact
        # arithmetic the scaled PCG is the unscaled one; ``norm_weight``
        # keeps the original system's stopping rule.
        aug_diag = torch.as_tensor(
            self.A.diag_host() + self.C.al_term_diag(w_diag_scalar, gamma),
            dtype=dt, device=dev)
        dsc = torch.where(free, 1.0 / torch.sqrt(aug_diag), 1.0)
        dsc_inv = torch.where(free, torch.sqrt(aug_diag), 1.0)
        # a float32 CG needs a reduction floor (its absolute tolerance can
        # sit below the reachable residual of this ill-scaled block); a
        # float64 one keeps the reference's absolute control
        inner_red = 1e-2 if dt == torch.float32 else None

        def aug_inv(v):
            def A_s(y):
                return dsc * aug_mv(dsc * y)

            def M_s(r):
                return dsc_inv * gmg.apply(dsc_inv * r)

            x, _ = block_solve(A_s, dsc * v, M=M_s, tol=cfg.al.tolerance,
                               reduction=inner_red,
                               max_steps=cfg.al.max_iterations,
                               norm_weight=dsc_inv, stats=self.stats)
            return dsc * x

        AA = block_operator(layout, layout, [
            [LinOp(aug_mv, (layout.sizes[0],) * 2), Bt_lin, Ct_lin],
            [B_lin, None, None],
            [C_lin, None, None]])
        if cfg.al.diagonal_spd_prec:
            prec = al_preconditioner_diagonal(layout, aug_inv, inv_w, mp_inv,
                                              gamma, gamma_gd)
        else:
            prec = al_preconditioner_stokes(layout, aug_inv, Bt_lin, Ct_lin,
                                            inv_w, mp_inv, gamma, gamma_gd)
        self._parts = dict(system_operator=AA, prec=prec, inv_w=inv_w,
                           Ct_lin=Ct_lin, gmg=gmg)
        return self._parts

    def _build_ibstokes_al(self, raw_rhs: bool = False,
                           max_steps: int | None = None):
        """IBStokesAL (stokes_immersed_boundary.cc:918-1074):
        ``run(rhs_u, rhs_g, bc_values) -> (x, info)`` on the parts of
        :meth:`_al_parts`, or with ``raw_rhs`` ``run_raw(r0, r1, r2) ->
        (x, info)`` for an assembled block right-hand side (the correction
        solve of :meth:`solve_refined`).  ``max_steps`` caps the outer steps
        (default ``cfg.outer.max_steps``).  FGMRES, or MinRes with the SPD
        diagonal preconditioner, in float64."""
        cfg = self.cfg
        layout, free = self.layout, self.free
        gamma = cfg.al.gamma
        parts = self._al_parts()
        if max_steps is None:
            max_steps = cfg.outer.max_steps

        def solve_core(b):
            kw = dict(tol=cfg.outer.tolerance, reduction=cfg.outer.reduction,
                      max_steps=max_steps, stats=self.stats)
            if cfg.al.diagonal_spd_prec:
                return minres(parts["system_operator"], b, parts["prec"],
                              **kw)
            return fgmres(parts["system_operator"], b, parts["prec"],
                          restart=cfg.fgmres_restart, **kw)

        if raw_rhs:
            def run_raw(r0, r1, r2):
                return solve_core(layout.concat((r0, r1, r2)))

            return run_raw

        A_raw = self.A.as_linop()
        inv_w, Ct_lin = parts["inv_w"], parts["Ct_lin"]

        def run(rhs_u, rhs_g, bc_values):
            b0 = dirichlet_rhs(A_raw, rhs_u, free, bc_values)
            b0 = b0 + torch.where(free, gamma * Ct_lin(inv_w(rhs_g)), 0.0)
            g_ext = torch.where(free, 0.0, bc_values)
            b1 = -self.B.mv(g_ext)     # lifting of the velocity Dirichlet data
            b2 = rhs_g - self.C.mv(g_ext)
            x, info = solve_core(layout.concat((b0, b1, b2)))
            u, p, lam = layout.split(x)
            u = torch.where(free, u, bc_values)
            return layout.concat((u, p, lam)), info

        return run

    def _a_inv_exact(self):
        """Tight GMG-preconditioned CG on the velocity block (the UMFPACK
        stand-in of the baselines)."""
        gmg = self._gmg_velocity(False, 0.0, None)
        A_lin = constrain(self.A.as_linop(), self.free)

        def A_inv(v):
            x, _ = cg(A_lin, v, M=gmg.apply, tol=0.0, reduction=1e-12,
                      max_steps=2000, stats=self.stats)
            return x

        return A_inv

    def _build_stokes_schur(self):
        """Plain Stokes Schur-complement CG (the step-22 baseline,
        stokes_immersed_boundary.cc:830-876; InverseMatrix and
        SchurComplement at lines 83-142).  The immersed body is ignored."""
        layout = self.layout
        A_inv = self._a_inv_exact()
        _, B_lin, Bt_lin, _, _ = self._blocks()
        free = self.free
        A_raw = self.A.as_linop()
        Mp = self.Mp
        lump = 1.0 / Mp.row_sums()

        def mp_approx_inv(v):
            x, _ = cg(Mp.mv, v, M=lambda r: lump * r, tol=0.0,
                      reduction=1e-10, max_steps=500, stats=self.stats)
            return x

        def run(rhs_u, rhs_g, bc_values):
            b0 = dirichlet_rhs(A_raw, rhs_u, free, bc_values)
            schur_rhs = B_lin(A_inv(b0))

            def S(p):
                return B_lin(A_inv(Bt_lin(p)))

            p, info = cg(S, schur_rhs, M=mp_approx_inv,
                         tol=1e-6 * float(torch.linalg.norm(schur_rhs)),
                         max_steps=layout.sizes[1], stats=self.stats)
            u = A_inv(b0 - Bt_lin(p))
            u = torch.where(free, u, bc_values)
            lam = torch.zeros(layout.sizes[2], dtype=u.dtype,
                              device=u.device)
            return layout.concat((u, p, lam)), info

        return run

    def _build_ibstokes(self):
        """IBStokes: nested exact Schur complements, no preconditioner
        (stokes_immersed_boundary.cc:877-917)."""
        layout = self.layout
        A_inv = self._a_inv_exact()
        _, B_lin, Bt_lin, C_lin, Ct_lin = self._blocks()
        free = self.free
        A_raw = self.A.as_linop()
        n_p = layout.sizes[1]

        def run(rhs_u, rhs_g, bc_values):
            b0 = dirichlet_rhs(A_raw, rhs_u, free, bc_values)

            def SBB(p):
                return B_lin(A_inv(Bt_lin(p)))

            def SBB_inv(v):
                x, _ = cg(SBB, v, tol=1e-10, max_steps=100 * n_p,
                          stats=self.stats)
                return x

            def S_lambda(lam):
                t = A_inv(Ct_lin(lam))
                return C_lin(t) - C_lin(A_inv(Bt_lin(SBB_inv(B_lin(t)))))

            A_inv_f = A_inv(b0)
            rhs_lam = (C_lin(A_inv_f) - rhs_g
                       - C_lin(A_inv(Bt_lin(SBB_inv(B_lin(A_inv_f))))))
            lam, info = cg(S_lambda, rhs_lam, tol=1e-10,
                           max_steps=100 * layout.sizes[2], stats=self.stats)
            p = SBB_inv(B_lin(A_inv_f) - B_lin(A_inv(Ct_lin(lam))))
            u = A_inv(b0 - Bt_lin(p) - Ct_lin(lam))
            u = torch.where(free, u, bc_values)
            return layout.concat((u, p, lam)), info

        return run

    # -- solve ----------------------------------------------------------------

    def solve(self):
        """Build the configured solver (once a setup) and run it; returns
        ``(u, p, λ, info)``.  ``results`` records the outer iterations,
        convergence, the solve and build seconds, the host syncs and the
        inner CG iterations (``inner_iterations``)."""
        solver = self.cfg.solver
        build = {"Stokes": self._build_stokes_schur,
                 "IBStokes": self._build_ibstokes,
                 "IBStokesAL": self._build_ibstokes_al}[solver]
        x, info = self.session.solve(solver, solver, build, self.rhs_u,
                                     self.rhs_g, self.bc_values)
        self.u, self.p, self.lam = self.layout.split(x)
        self.results.update(
            dofs_background=self.layout.sizes[0] + self.layout.sizes[1],
            dofs_immersed=self.layout.sizes[2],
            outer_iterations=int(info.iterations),
            converged=bool(info.converged), residual=float(info.residual))
        return self.u, self.p, self.lam, info

    def build_correction_solver(self):
        """``(r0, r1, r2) -> (x, info)``: one AL-preconditioned solve of the
        IBStokesAL system with a raw right-hand side, its outer steps capped
        at ``utils.refine.CORRECTION_MAX_OUTER`` (the inner engine of
        :meth:`solve_refined`)."""
        if self.cfg.solver != "IBStokesAL":
            raise ValueError("solve_refined needs the IBStokesAL solver")
        return self._build_ibstokes_al(
            raw_rhs=True,
            max_steps=min(self.cfg.outer.max_steps, CORRECTION_MAX_OUTER))

    def solve_refined(self, tol_abs: float = 1e-8, max_refine: int = 12):
        """Iterative refinement of the IBStokesAL solve to the reference's
        1e-8 'Stokes solver control' (parameters_stokes.prm): correction
        solves on the device, the true float64 residual of the 3x3 block
        system on the host (:class:`..ops.host_ref.HostStokesSystem`), looped
        to ``tol_abs`` under the guard of
        :func:`..utils.refine.guarded_refinement`.

        Returns ``(u, p, λ, history)``: float64 NumPy iterates and the
        accepted true residual norms.  ``results`` records the total outer
        iterations, the final residual, the accepted steps, convergence, the
        seconds of the loop, of the device corrections and of the host
        residuals, and the host syncs
        (:meth:`.session.SolveSession.refine`).  The host system and the
        correction solver are built once per :meth:`setup`, on the operator
        and preconditioner :meth:`solve` built."""
        (u, p, lam), history = self.session.refine(
            HostStokesSystem,
            lambda: split_correction(self.layout,
                                     self.build_correction_solver()),
            self.layout.sizes, self.OP_DTYPE, ("u", "p", "lam"), tol_abs,
            max_refine)
        self.results.update(
            dofs_background=self.layout.sizes[0] + self.layout.sizes[1],
            dofs_immersed=self.layout.sizes[2])
        return u, p, lam, history

    # -- diagnostics ----------------------------------------------------------

    def constraint_residual(self) -> float:
        """||C u - g||_inf."""
        return float(torch.max(torch.abs(self.C.mv(self.u) - self.rhs_g)))

    def divergence_residual(self) -> float:
        """||B u||: how incompressible the computed velocity is."""
        return float(torch.linalg.norm(self.B.mv(self.u)))

    def run(self):
        self.setup()
        self.solve()
        return self.results
