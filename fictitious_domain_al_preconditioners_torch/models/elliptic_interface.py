"""Elliptic interface problem with a codim-0 immersed domain (3x3 block DLM).

Counterpart of
``fictitious_domain_al_preconditioners_tpu.models.elliptic_interface`` (the
reference's ``elliptic_interface`` executable, elliptic_interface.cc, class
``EllipticInterfaceDLM``):

    -β₁Δu = f   in Ω,      -(β₂-β₁)Δu₂ (+ coupling) = f₂-f  in ω ⊂ Ω,
    u|_ω = u₂ (via multiplier λ), coefficient jump β₂ ≫ β₁.

    system (elliptic_interface.cc:816-819, augmented):
    [ A₁+γ₁CᵀW⁻¹C   -γ₁CᵀW⁻¹M      Cᵀ ] [u ]   [f₁]
    [ -γ₂MW⁻¹C       A₂+γ₂MW⁻¹M    -M ] [u₂] = [f₂-f]
    [ C              -M             0  ] [λ ]   [0]

Preconditioners: the 'ideal' AL (coupled 2x2 inverse, C4) and the paper's
modified AL (block-triangular, C5), with the four W variants, the γ study,
the √2 rule, the h-scaled mass, the operator-form AL term, fixed inner
iterations, and the manufactured convergence study (the radial solution of
arXiv 2211.03443, elliptic_interface.cc:56-102).  The outer solver is
FGMRES; the A11 inner solves are CG preconditioned by a lattice GMG V-cycle
whose levels carry the AL term as the band stencil of the diag-weighted
γ·Cᵀdiag(w)C (``ops.sparse_band``) or, in operator form, as the 9-point
particle patch; A22 is solved by CG on GMG over the immersed box's lattice
twin, or, off-lattice, on a dense inverse or a Chebyshev smoother.

A degree-2 background or immersed space (``background_space_degree``,
``immersed_space_degree``) leaves the lattice on that side, as the
reference does: its stiffness and mass apply in element form, W⁻¹ = M⁻²
off the lattice is a nested Jacobi-CG (``precond.weights``), and its block's
V-cycle is the flat hierarchy of ``precond.gmg.build_gmg_flat``; the Q1
side keeps its lattice applies and K6.

Every block vector is flat; the blocks on a lattice go to their (ny, nx)
views inside the lattice applies.  The operator and every Krylov solver run
in float64; the V-cycles run in the problem's ``dtype`` (float32 on CUDA).
On CUDA every lattice stiffness apply is kernel K6
(``ops.kernels.laplace_stencil_2d``, through ``LatticeOps.laplace``): its
float64 form in the outer operator and the inner CGs, its float32 form on
every level of both V-cycles, on the background and on the immersed lattice
twin.  The band stencil, the lattice mass and its banded inverse are plain
PyTorch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.generators import background_grid_from_name, immersed_mesh_from_name
from ..core.grid import GridSpace
from ..core.immersed import ImmersedSpace
from ..ops.assembly import (h1_error, imm_mass_matrix, imm_rhs,
                            imm_stiffness_matrix, interpolate, l2_error,
                            laplace_matrix, mass_matrix, rhs_vector)
from ..ops.blocks import BlockLayout, block_operator
from ..ops.coupling import build_coupling
from ..ops.host_ref import HostEllipticSystem
from ..ops.krylov import cg, cg_condition_number, fgmres, lanczos_max_eig
from ..ops.linop import LinOp
from ..ops.operators import constrain, dirichlet_rhs
from ..ops.sparse import COO, spgemm_ctwc
from ..ops.sparse_band import lattice_band_linop
from ..parallel.lattice import LatticeOps
from ..precond.al import (al_preconditioner_ideal, al_preconditioner_modified,
                          block_solve)
from ..precond.chebyshev import chebyshev
from ..precond.gmg import build_gmg, build_gmg_flat
from ..precond.weights import (diag_of_m_squared, inv_diag,
                               inv_diag_of_m_squared, inv_exact,
                               inv_squared_exact)
from ..utils.expressions import ParsedFunction
from ..utils.prm import Params, parse_prm
from ..utils.refine import CORRECTION_MAX_OUTER
from ..utils.report import ConvergenceTable
from ..utils.timer import TimerOutput
from .session import SolveSession, split_correction

__all__ = ["ControlConfig", "EllipticInterfaceConfig",
           "EllipticInterfaceProblem", "exact_solution", "exact_gradient"]


# Analytical radial solution with coefficient jump (elliptic_interface.cc:56-102,
# from arXiv 2211.03443); beta_1=1, beta_2=10, immersed unit ball, f == 1.
def exact_solution(p, beta1=1.0, beta2=10.0, dim=2):
    r2 = np.sum(np.asarray(p) ** 2, axis=-1)
    inside = (3.0 * beta2 / beta1 + 1.0 - r2) / (2.0 * dim * beta2)
    outside = (4.0 - r2) / (2.0 * dim * beta1)
    return np.where(r2 <= 1.0, inside, outside)


def exact_gradient(p, beta1=1.0, beta2=10.0, dim=2):
    p = np.asarray(p)
    r2 = np.sum(p ** 2, axis=-1, keepdims=True)
    return np.where(r2 <= 1.0, -p / (dim * beta2), -p / (dim * beta1))


@dataclass
class ControlConfig:
    max_steps: int = 1000
    tolerance: float = 1e-10
    reduction: float | None = 1e-20


@dataclass
class EllipticInterfaceConfig:
    """Mirror of ``ProblemParameters`` (elliptic_interface.cc:117-321); field
    names and defaults as in the JAX package."""

    output_directory: str = "."
    initial_background_refinement: int = 4
    initial_immersed_refinement: int = 2
    name_of_background_grid: str = "hyper_cube"
    arguments_for_background_grid: str = "-1: 1: true"
    name_of_immersed_grid: str = "hyper_cube"
    arguments_for_immersed_grid: str = "-0.14: 0.44: true"
    n_refinement_cycles: int = 5
    beta_1: float = 1.0
    beta_2: float = 10.0
    dirichlet_ids: tuple = (0, 1, 2, 3)
    background_space_degree: int = 1
    immersed_space_degree: int = 1
    coupling_quadrature_order: int = 3
    use_modified_AL_preconditioner: bool = False
    do_parameter_study: bool = False
    start_gamma: float = 1e-3
    end_gamma: float = 1.0
    n_steps_gamma: int = 100
    use_diagonal_inverse: bool = False
    use_h_scaled_mass: bool = False
    use_operator_form: bool = False
    use_sqrt_2_rule: bool = False
    do_sanity_checks: bool = True
    do_convergence_study: bool = False
    export_matrices_for_eig_analysis: bool = False
    gamma_AL_background: float = 10.0
    gamma_AL_immersed: float = 10.0
    use_fixed_iterations: bool = True
    outer: ControlConfig = field(default_factory=ControlConfig)
    inner: ControlConfig = field(default_factory=lambda: ControlConfig(
        max_steps=1000, tolerance=1e-4, reduction=1e-20))
    iteration_number: ControlConfig = field(default_factory=lambda: ControlConfig(
        max_steps=30, tolerance=1e-4, reduction=None))
    f_1: tuple = ("1.", "")
    f_2_minus_f: tuple = ("1.", "")
    fgmres_restart: int = 50  # max_basis_size (elliptic_interface.cc:863)

    def __post_init__(self):
        # sanity checks mirroring elliptic_interface.cc:408-447
        assert self.beta_1 > 0.0, "Beta_1 must be positive."
        assert self.beta_2 > self.beta_1, "Beta_2 must be greater than Beta_1."
        assert self.gamma_AL_background > 0.0
        assert self.gamma_AL_immersed <= self.gamma_AL_background, \
            "gamma2 (solid) should be <= gamma (fluid)"
        if self.do_parameter_study:
            assert self.use_modified_AL_preconditioner, \
                "Parameter study requires the modified AL preconditioner"
        if self.use_sqrt_2_rule:
            assert self.use_modified_AL_preconditioner, \
                "sqrt(2)-rule requires the modified AL preconditioner"

    @classmethod
    def from_prm(cls, text_or_path) -> "EllipticInterfaceConfig":
        text = text_or_path
        if "\n" not in str(text_or_path):
            with open(text_or_path) as fh:
                text = fh.read()
        p = Params(parse_prm(text)).enter("Elliptic Interface Problem")
        al = p.enter("AL preconditioner")
        grids = p.enter("Grid generation")
        study = p.enter("Parameter study")
        ref = p.enter("Refinement and remeshing")

        def ctl(section, **defaults):
            s = p.enter(section)
            return ControlConfig(
                max_steps=s.get_int("Max steps", defaults.get("max_steps", 100)),
                tolerance=s.get_float("Tolerance", defaults.get("tolerance", 1e-10)),
                reduction=(s.get_float("Reduction", defaults["reduction"])
                           if "reduction" in defaults else None))

        def fn(section, default):
            s = p.enter(section)
            return (s.get_str("Function expression", default),
                    s.get_str("Function constants", ""))

        return cls(
            output_directory=p.get_str("Output directory", "."),
            initial_background_refinement=ref.get_int("Initial background refinement", 4),
            initial_immersed_refinement=ref.get_int("Initial immersed refinement", 2),
            n_refinement_cycles=ref.get_int("Refinemented cycles", 5),
            name_of_background_grid=grids.get_str("Background grid generator", "hyper_cube"),
            arguments_for_background_grid=grids.get_str("Background grid generator arguments", "-1: 1: true"),
            name_of_immersed_grid=grids.get_str("Immersed grid generator", "hyper_cube"),
            arguments_for_immersed_grid=grids.get_str("Immersed grid generator arguments", "-0.14: 0.44: true"),
            beta_1=p.get_float("Beta_1", 1.0),
            beta_2=p.get_float("Beta_2", 10.0),
            dirichlet_ids=tuple(p.get_int_list("Homogeneous Dirichlet boundary ids", (0, 1, 2, 3))),
            background_space_degree=p.get_int("FE degree background", 1),
            immersed_space_degree=p.get_int("FE degree immersed", 1),
            coupling_quadrature_order=p.get_int("Coupling quadrature order", 3),
            use_modified_AL_preconditioner=al.get_bool("Use modified AL preconditioner", False),
            do_parameter_study=al.get_bool("Do parameter study", False),
            use_diagonal_inverse=al.get_bool("Use diagonal inverse", False),
            use_sqrt_2_rule=al.get_bool("Use sqrt(2)-rule for gamma", False),
            gamma_AL_background=al.get_float("gamma fluid", 10.0),
            gamma_AL_immersed=al.get_float("gamma solid", 10.0),
            use_h_scaled_mass=p.get_bool("Use h-scaled mass matrix", False),
            use_operator_form=p.get_bool("Use operator form", False),
            do_sanity_checks=p.get_bool("Perform sanity checks", True),
            do_convergence_study=p.get_bool("Perform convergence study", False),
            export_matrices_for_eig_analysis=p.get_bool("Export matrices for eigs-analysis", False),
            use_fixed_iterations=p.get_bool("Use fixed (inner) iterations", True),
            start_gamma=study.get_float("Start gamma", 1e-3),
            end_gamma=study.get_float("Stop gamma", 1.0),
            n_steps_gamma=study.get_int("Number of steps", 100),
            outer=ctl("Outer solver control", max_steps=1000, tolerance=1e-10, reduction=1e-20),
            inner=ctl("Inner solver control", max_steps=1000, tolerance=1e-4, reduction=1e-20),
            iteration_number=ctl("Iteration number control", max_steps=30, tolerance=1e-4),
            f_1=fn("Right hand side f_1", "1."),
            f_2_minus_f=fn("Right hand side f_2 - f", "1."),
        )


def _is_lattice(sp) -> bool:
    return (sp is not None and sp.fe.degree == 1 and sp.continuous
            and hasattr(sp, "n_points_1d"))


class EllipticInterfaceProblem:
    """``EllipticInterfaceProblem(cfg).setup(cycle)`` then ``.solve()``.  The
    problem runs on the CUDA card unless ``device="cpu"`` is given.

    ``dtype`` sets the preconditioner's precision only: that of the
    multigrid V-cycles and of the off-lattice A22 surrogate inverse, float64
    on the CPU and float32 on CUDA by default.  The problem's arrays, the
    3x3 operator, the Krylov solvers and the solution are float64 whatever
    ``dtype`` is (see :meth:`_solver_parts`), unlike
    ``ImmersedLaplaceProblem``, whose ``dtype`` is the whole solve's.
    ``lanczos_start`` and ``lanczos_start_a22`` (optional attributes,
    ``(level_index, n) -> ndarray``) inject the Lanczos start vectors of the
    A11 hierarchy and of A22's (its GMG levels, or the off-lattice
    Chebyshev as level 0)."""

    def __init__(self, config: EllipticInterfaceConfig, *, device="cuda",
                 dtype=None):
        self.cfg = config
        self.device = torch.device(device)
        self.dtype = dtype or (torch.float64 if self.device.type == "cpu"
                               else torch.float32)
        self.timer = TimerOutput()
        self.table = ConvergenceTable()
        self.results = {}
        self.stats = {"host_syncs": 0, "inner_iterations": 0}
        self.lanczos_start = None
        self.lanczos_start_a22 = None
        # mutable AL parameters (the √2 rule and the γ study change them)
        self.gamma_bg = config.gamma_AL_background
        self.gamma_imm = config.gamma_AL_immersed
        self._parts = {}
        self._particle_coupling = None
        self.session = SolveSession(self, "elliptic_interface")

    # -- per-cycle setup ----------------------------------------------------

    def setup(self, cycle: int = 0):
        cfg = self.cfg
        # the problem's arrays are float64, like the outer solve; the
        # preconditioner takes copies in self.dtype
        dev, dt = self.device, torch.float64
        t0 = time.perf_counter()
        with self.timer.scope("Grid generation"):
            if cfg.do_convergence_study:
                # ad-hoc grids (elliptic_interface.cc:451-461)
                self.beta_1, self.beta_2 = 1.0, 10.0
                self.grid = background_grid_from_name(
                    "hyper_cube", "-1.4: 1.4: false", 2,
                    cfg.initial_background_refinement + cycle)
                self.fg_mesh = immersed_mesh_from_name(
                    "hyper_ball", "0,0 : 1.", 2,
                    cfg.initial_immersed_refinement + cycle)
            else:
                self.beta_1, self.beta_2 = cfg.beta_1, cfg.beta_2
                self.grid = background_grid_from_name(
                    cfg.name_of_background_grid,
                    cfg.arguments_for_background_grid, 2,
                    cfg.initial_background_refinement + cycle)
                self.fg_mesh = immersed_mesh_from_name(
                    cfg.name_of_immersed_grid,
                    cfg.arguments_for_immersed_grid, 2,
                    cfg.initial_immersed_refinement + cycle)

        with self.timer.scope("System setup"):
            self.space = GridSpace.q(self.grid, cfg.background_space_degree)
            # an immersed box gets its space on the lattice numbering of a
            # GridSpace twin, so A22 is solved by lattice GMG and its mass
            # and stiffness apply as lattice stencils
            self.fg_gridspace = None
            if (not cfg.do_convergence_study and cfg.name_of_immersed_grid
                    in ("hyper_cube", "hyper_rectangle")):
                fg_grid = background_grid_from_name(
                    cfg.name_of_immersed_grid,
                    cfg.arguments_for_immersed_grid, 2,
                    cfg.initial_immersed_refinement + cycle)
                self.fg_gridspace = GridSpace.q(fg_grid,
                                                cfg.immersed_space_degree)
                # immersed_uniform_grid keeps the grid's cell order, so the
                # lattice cell_dofs apply verbatim on the immersed mesh
                self.fg_space = ImmersedSpace(
                    self.fg_mesh, self.fg_gridspace.fe,
                    self.fg_gridspace.cell_dofs, self.fg_gridspace.n_dofs)
            else:
                self.fg_space = self.fg_mesh.space(cfg.immersed_space_degree)
            deg = cfg.background_space_degree
            ideg = cfg.immersed_space_degree
            self.A1 = laplace_matrix(self.space, order=deg + 1, device=dev,
                                     dtype=dt)
            # A2 is scaled by (beta_2 - beta_1) where it is applied
            self.A2 = imm_stiffness_matrix(self.fg_space, order=ideg + 1,
                                           device=dev, dtype=dt)
            self.A2_scale = self.beta_2 - self.beta_1
            self.M = imm_mass_matrix(self.fg_space, order=ideg + 1,
                                     device=dev, dtype=dt)

            if cfg.do_convergence_study:
                self.f1_fn = lambda p: np.ones(np.asarray(p).shape[0])
                self.f2_fn = lambda p: np.zeros(np.asarray(p).shape[0])
                self.bc_values = interpolate(self.space, exact_solution,
                                             device=dev, dtype=dt)
                self.free = torch.as_tensor(
                    ~self.space.boundary_dof_mask(None), device=dev)
            else:
                self.f1_fn = ParsedFunction(*cfg.f_1)
                self.f2_fn = ParsedFunction(*cfg.f_2_minus_f)
                self.bc_values = torch.zeros(self.space.n_dofs, dtype=dt,
                                             device=dev)
                self.free = torch.as_tensor(
                    ~self.space.boundary_dof_mask(list(cfg.dirichlet_ids)),
                    device=dev)
            self.rhs_f1 = rhs_vector(self.space, self.f1_fn, order=deg + 1,
                                     device=dev, dtype=dt)
            self.rhs_f2 = imm_rhs(self.fg_space, self.f2_fn, order=ideg + 1,
                                  device=dev, dtype=dt)

        with self.timer.scope("Coupling setup"):
            # the reference uses QGauss(fe_bg.degree + 1) here
            # (elliptic_interface.cc:574)
            self.C = build_coupling(self.space, self.fg_space, order=deg + 1,
                                    device=dev, dtype=dt)

        self.layout = BlockLayout((self.space.n_dofs, self.fg_space.n_dofs,
                                   self.fg_space.n_dofs))
        self._parts = {}
        self._particle_coupling = None
        self.session.reset()
        self.results["setup_seconds"] = time.perf_counter() - t0
        return self

    def load_state(self, state):
        """Replace the setup arrays by carried ones (see
        :func:`..utils.carry.state_from_jax`): right-hand sides, Dirichlet
        data and mask, the coupling table, A1, A2 and M, and the Lanczos
        start vectors of both hierarchies.  The solver is rebuilt at the
        next solve."""
        self.rhs_f1, self.rhs_f2 = state.rhs_f1, state.rhs_f2
        self.bc_values, self.free = state.bc_values, state.free
        self.C = state.coupling
        self.A1, self.A2, self.M = state.A1, state.A2, state.M
        for attr, starts in (("lanczos_start", state.lanczos_starts),
                             ("lanczos_start_a22",
                              state.lanczos_starts_a22)):
            if starts is not None:
                setattr(self, attr, lambda i, n, s=starts: s[i])
        self._parts = {}
        self._particle_coupling = None
        self.session.reset()
        return self

    # -- operators ------------------------------------------------------------

    def _lap_apply(self, sp, cm):
        """Q1 stiffness apply on flat vectors: the lattice stencil of ``sp``
        when it is a Q1 lattice (``LatticeOps.laplace``: K6 on CUDA, in the
        vector's float32 or float64), else the element form."""
        if _is_lattice(sp):
            lat = LatticeOps.for_space(sp)

            def mv(x):
                return lat.laplace(x.reshape(lat.shape)).reshape(x.shape)

            return mv
        return cm.mv

    def _mass_apply(self, sp, cm):
        """Q1 mass apply on flat vectors, as :meth:`_lap_apply`."""
        if _is_lattice(sp):
            lat = LatticeOps.for_space(sp)

            def mv(x):
                return lat.mass(x.reshape(lat.shape)).reshape(x.shape)

            return mv
        return cm.mv

    @staticmethod
    def _level_op(sp, mv, mask):
        """The masked level operator of :func:`..precond.gmg.build_gmg` on
        (ny, nx) tensors, ``m*A(m*x) + (1-m)*x`` with ``mv`` acting on flat
        vectors; ``mask`` is the level's free-dof mask (bool, flat), None
        when every dof is free."""
        lat = tuple(reversed(sp.n_points_1d))
        if mask is None:
            def op(x2):
                return mv(x2.reshape(-1)).reshape(lat)

            return op
        m2 = mask.reshape(lat)

        def op(x2):
            y = mv(torch.where(m2, x2, 0.0).reshape(-1)).reshape(lat)
            return torch.where(m2, y, x2)

        return op

    def _level_masks(self, fine_space, free):
        """Free-dof mask of every GMG level of ``fine_space`` (flat bool
        tensors, fine first), derived from the fine mask's constrained faces
        as :func:`..precond.gmg.build_gmg` derives them; None where every
        dof is free."""
        fine = free.cpu().numpy()
        constrained = [bid for bid in range(2 * fine_space.grid.dim)
                       if not fine[fine_space.boundary_dof_mask([bid])].any()]

        def mask(sp):
            if sp is fine_space:
                m = fine
            elif constrained:
                m = ~sp.boundary_dof_mask(constrained)
            else:
                return None
            return None if m.all() else torch.as_tensor(m,
                                                        device=self.device)

        return mask

    def _gmg(self, space, factory, free, lanczos_start):
        """The V-cycle of an augmented block over ``space`` in ``self.dtype``,
        ``(gmg, apply)`` with ``apply`` on flat vectors.  ``factory(sp) ->
        (mv, diag)`` gives a level's unconstrained operator on flat vectors
        and its assembled diagonal.  A Q1 lattice takes the lattice
        hierarchy (its levels masked here, K6 inside ``mv``), any other
        space the flat one of :func:`..precond.gmg.build_gmg_flat`, as the
        reference's ``build_gmg`` routes a degree-2 space
        (elliptic_interface.py:474, :505)."""
        kw = dict(free_mask=free, lanczos_start=lanczos_start,
                  dtype=self.dtype, stats=self.stats)
        if not _is_lattice(space):
            gmg = build_gmg_flat(space, factory, **kw)
            return gmg, gmg.apply
        masks = self._level_masks(space, free)

        def lattice_factory(sp):
            mv, diag = factory(sp)
            return self._level_op(sp, mv, masks(sp)), diag, None

        gmg = build_gmg(space, lattice_factory, **kw)
        lat = tuple(reversed(space.n_points_1d))

        def apply(v):
            return gmg.apply(v.reshape(lat)).reshape(-1)

        return gmg, apply

    def _gammas(self):
        """(γ₁, γ₂) of the system: the current γ's, divided by h_imm² in the
        h-scaled and operator forms."""
        cfg = self.cfg
        g1, g2 = self.gamma_bg, self.gamma_imm
        if cfg.use_h_scaled_mass or cfg.use_operator_form:
            h_imm = self.fg_mesh.h_max
            g1, g2 = g1 / h_imm ** 2, g2 / h_imm ** 2
        return g1, g2

    def _blocks(self):
        """The blocks of the 3x3 system in float64: A1, M, C, Cᵀ, W⁻¹ and
        the augmented A11, A12, A21, A22, as flat-vector LinOps."""
        cfg = self.cfg
        dev, dt = self.device, torch.float64
        gamma_1, gamma_2 = self._gammas()
        beta_1, a2_scale = self.beta_1, self.A2_scale
        A1, A2, M = (m.astype(dt) for m in (self.A1, self.A2, self.M))
        C = self.C.astype(dt)

        a1_mv = self._lap_apply(self.space, A1)
        A1_lin = LinOp(lambda x: beta_1 * a1_mv(x), A1.shape,
                       lambda x: beta_1 * a1_mv(x))
        # the immersed mesh of a box has its twin's numbering, so the
        # lattice applies are the same matrices as A2 and M
        a2_mv = self._lap_apply(self.fg_gridspace, A2)
        A2_lin = LinOp(lambda x: a2_scale * a2_mv(x), A2.shape,
                       lambda x: a2_scale * a2_mv(x))
        m_mv = self._mass_apply(self.fg_gridspace, M)
        M_lin = LinOp(m_mv, M.shape, m_mv)
        C_lin = C.as_linop()
        Ct_lin = C_lin.T
        n_bg, n_fg = self.space.n_dofs, self.fg_space.n_dofs

        # W⁻¹ (elliptic_interface.cc:700-739); the exact inverses are the
        # tensor-product lattice inverse when the immersed space is a box
        if cfg.use_h_scaled_mass or cfg.use_operator_form:
            inv_w = (inv_diag(M) if cfg.use_diagonal_inverse
                     else inv_exact(M, space=self.fg_gridspace))
        else:
            inv_w = (inv_diag_of_m_squared(M) if cfg.use_diagonal_inverse
                     else inv_squared_exact(M, space=self.fg_gridspace))

        if cfg.use_operator_form:
            # the particle AL term, at the reference's quadrature order
            if self._particle_coupling is None:
                self._particle_coupling = build_coupling(
                    self.space, self.fg_space,
                    order=2 * cfg.background_space_degree + 1, device=dev)
            Cpart = self._particle_coupling.astype(dt)
            st = Cpart.patch_stencil_al(self.space, gamma_1)
            AL11 = (st[0] if st is not None
                    else Cpart.particle_mass_term(gamma_1))
        else:
            AL11 = C.al_term(inv_w, gamma_1)

        def A22_mv(x):
            return A2_lin(x) + gamma_2 * M_lin(inv_w(M_lin(x)))

        # off-diagonal augmented blocks (elliptic_interface.cc:810-813)
        def A12_mv(x):
            return -gamma_1 * Ct_lin(inv_w(M_lin(x)))

        def A21_mv(x):
            return -gamma_2 * M_lin(inv_w(C_lin(x)))

        return dict(
            A1=A1_lin, M_lin=M_lin, C_lin=C_lin, Ct_lin=Ct_lin, inv_w=inv_w,
            A11=constrain(A1_lin + AL11, self.free),
            A12=LinOp(A12_mv, (n_bg, n_fg)), A21=LinOp(A21_mv, (n_fg, n_bg)),
            A22=LinOp(A22_mv, (n_fg, n_fg)))

    def _solver_parts(self):
        """The 3x3 operator and the AL preconditioner of the current γ's,
        built once (:meth:`solve` and the correction solves of
        :meth:`solve_refined` run on them).

        Every Krylov solver (FGMRES, the inner CGs) and every operator runs
        in float64 (K6's float64 form on CUDA); the multigrid V-cycles of A11
        and A22 (K6's float32 form on CUDA) and the off-lattice A22
        surrogate inverse run in ``self.dtype``, cast at their boundary.  In
        float32 the stiffness of a smooth field cancels to O(h²) of its
        terms and the jump β₂/β₁ = 1e3 multiplies A2's, so a float32
        operator, or a float32 A22 solution handed to it, loses the residual
        at the reference's scale (at cycle 6 a float32 solve's true residual
        was 8x its right-hand side's, and a float32 A22⁻¹ output alone
        multiplied the outer counts).  A preconditioner only has to be
        close: float32 V-cycles leave the counts as float64 ones give
        them."""
        cfg = self.cfg
        key = (round(self.gamma_bg, 12), round(self.gamma_imm, 12),
               cfg.use_modified_AL_preconditioner)
        if key in self._parts:
            return self._parts[key]
        dev, dt = self.device, self.dtype
        layout = self.layout
        gamma_1, gamma_2 = self._gammas()
        deg = cfg.background_space_degree
        beta_1, a2_scale = self.beta_1, self.A2_scale
        ops = self._blocks()
        free = self.free
        n_bg, n_fg = self.space.n_dofs, self.fg_space.n_dofs
        M = self.M
        if cfg.use_h_scaled_mass or cfg.use_operator_form:
            w_diag = 1.0 / M.diag_host()
        else:
            w_diag = 1.0 / diag_of_m_squared(M)

        # A11's GMG.  Every level carries the diag-weighted surrogate
        # γ·Cᵀdiag(w)C, as the reference's AMG is built on the
        # diag-weighted explicit matrix (elliptic_interface.cc:821-851);
        # the operator keeps the exact W⁻¹.  In operator form the particle
        # term on every level.
        def level_coupling(sp, order):
            # host tables only; a level that needs the gather form moves
            # them to the card
            return build_coupling(sp, self.fg_space, order=order,
                                  device="cpu")

        if cfg.use_operator_form:
            def al_factory(sp):
                Cp = (self._particle_coupling if sp is self.space
                      else level_coupling(sp, 2 * deg + 1)).to(dev, dt)
                # the 9-point patch stencil on a Q1 lattice whose band is
                # interior; the particle gather form otherwise
                st = Cp.patch_stencil_al(sp, gamma_1)
                if st is not None:
                    return st
                return (Cp.particle_mass_term(gamma_1),
                        Cp.particle_mass_diag(gamma_1))
        else:
            wd = torch.as_tensor(w_diag, dtype=dt, device=dev)

            def al_factory(sp):
                Cl = self.C if sp is self.space else level_coupling(
                    sp, deg + 1)
                # the same matrix as a band stencil on a Q1 lattice level:
                # no gather or scatter in the smoother
                band = lattice_band_linop(
                    sp, spgemm_ctwc(COO.from_coupling(Cl), w_diag),
                    scale=gamma_1, device=dev, dtype=dt)
                if band is not None:
                    return band[0], band[2]
                Cl = Cl.to(dev, dt)

                def mv(x, Cl=Cl):
                    return gamma_1 * Cl.rmv(wd.to(x.dtype) * Cl.mv(x))

                return mv, Cl.al_term_diag(w_diag, gamma_1)

        def a11_factory(sp):
            # a Q1 lattice level: K6 (flat vectors, viewed as the lattice);
            # else the element form (a Q2 background, elliptic_interface.py:
            # 465 of the reference)
            K_l = None if _is_lattice(sp) else (
                self.A1 if sp is self.space else laplace_matrix(
                    sp, order=deg + 1, device=dev, dtype=dt)).astype(dt)
            k_mv = self._lap_apply(sp, K_l)
            al_mv, al_diag = al_factory(sp)

            def mv(x):
                return beta_1 * k_mv(x) + al_mv(x)

            k_diag = (LatticeOps.for_space(sp).laplace_diag() if K_l is None
                      else K_l.diag_host())
            return mv, beta_1 * k_diag + al_diag

        gmg11, gmg11_apply = self._gmg(self.space, a11_factory, free,
                                       self.lanczos_start)

        # A22's preconditioner: the reference builds AMG on the surrogate
        # A2 + γ₂(h-scaled M | I) (elliptic_interface.cc:838-851); GMG on
        # the lattice twin of a box, else a dense inverse (small meshes) or
        # Chebyshev
        use_mass_surrogate = cfg.use_h_scaled_mass or cfg.use_operator_form
        gmg22 = None
        if self.fg_gridspace is not None:
            ideg = cfg.immersed_space_degree

            def a22_factory(sp):
                lattice = _is_lattice(sp)
                K_l = None if lattice else laplace_matrix(
                    sp, order=ideg + 1, device=dev, dtype=dt)
                k_mv = self._lap_apply(sp, K_l)
                k_diag = a2_scale * (LatticeOps.for_space(sp).laplace_diag()
                                     if lattice else K_l.diag_host())
                if use_mass_surrogate:
                    M_l = None if lattice else mass_matrix(
                        sp, order=ideg + 1, device=dev, dtype=dt)
                    m_mv_l = self._mass_apply(sp, M_l)

                    def mv(x):
                        return a2_scale * k_mv(x) + gamma_2 * m_mv_l(x)

                    diag = k_diag + gamma_2 * (
                        LatticeOps.for_space(sp).mass_diag() if lattice
                        else M_l.diag_host())
                else:
                    def mv(x):
                        return a2_scale * k_mv(x) + gamma_2 * x

                    diag = k_diag + gamma_2
                return mv, diag

            gmg22, A22_prec = self._gmg(
                self.fg_gridspace, a22_factory,
                torch.ones(n_fg, dtype=torch.bool, device=dev),
                self.lanczos_start_a22)
        else:
            A2, M = self.A2.astype(dt), self.M.astype(dt)
            a2d = A2.diag_host()
            if use_mass_surrogate:
                a22_diag = a2_scale * a2d + gamma_2 * M.diag_host()

                def a22_sur(x):
                    return a2_scale * A2.mv(x) + gamma_2 * M.mv(x)
            else:
                a22_diag = a2_scale * a2d + gamma_2

                def a22_sur(x):
                    return a2_scale * A2.mv(x) + gamma_2 * x

            if n_fg <= 4000:
                # dense inverse of the surrogate, one matmul an apply
                eye = torch.eye(n_fg, dtype=dt, device=dev)
                dense = a22_sur(eye).cpu().double().numpy()
                inv22 = torch.as_tensor(np.linalg.inv(dense), dtype=dt,
                                        device=dev)

                def A22_prec(v):
                    return (inv22 @ v.to(dt)).to(v.dtype)
            else:
                a22_dinv = torch.as_tensor(1.0 / a22_diag, dtype=dt,
                                           device=dev)
                v0 = (self.lanczos_start_a22(0, n_fg)
                      if self.lanczos_start_a22 is not None else None)
                lam = lanczos_max_eig(lambda v: a22_dinv * a22_sur(v), n_fg,
                                      steps=10, v0=v0, dtype=dt, device=dev,
                                      stats=self.stats)
                cheb = chebyshev(a22_sur, a22_dinv, lam, degree=5)

                def A22_prec(v):
                    return cheb(v.to(dt)).to(v.dtype)

        inner_kw = (dict(tol=cfg.iteration_number.tolerance,
                         max_steps=cfg.iteration_number.max_steps,
                         fixed_iters=True) if cfg.use_fixed_iterations else
                    dict(tol=cfg.inner.tolerance,
                         reduction=cfg.inner.reduction,
                         max_steps=cfg.inner.max_steps))

        def A11_inv(v):
            x, _ = block_solve(ops["A11"], v, M=gmg11_apply,
                               stats=self.stats, **inner_kw)
            return x

        def A22_inv(v):
            x, _ = block_solve(ops["A22"], v, M=A22_prec, stats=self.stats,
                               **inner_kw)
            return x

        system_operator = block_operator(layout, layout, [
            [ops["A11"], ops["A12"], ops["Ct_lin"]],
            [ops["A21"], ops["A22"], -1.0 * ops["M_lin"]],
            [ops["C_lin"], -1.0 * ops["M_lin"], None],
        ])

        if cfg.use_modified_AL_preconditioner:
            assert self.gamma_imm <= 20.0, \
                "gamma_AL_immersed too large for modified AL"
            prec = al_preconditioner_modified(
                layout, A11_inv, A22_inv, ops["Ct_lin"], ops["M_lin"],
                ops["inv_w"], gamma_1)
        else:
            assert self.gamma_bg > 1.0, \
                "gamma probably too small for classical AL preconditioner"
            assert abs(self.gamma_bg - self.gamma_imm) < 1e-12, \
                "ideal AL requires gamma_1 == gamma_2"
            sub = BlockLayout((n_bg, n_fg))
            Aug2x2 = block_operator(sub, sub, [
                [ops["A11"], ops["A12"]], [ops["A21"], ops["A22"]]])

            def prec_aug(x):
                x0, x1 = sub.split(x)
                return sub.concat((gmg11_apply(x0), A22_prec(x1)))

            def aug_inv_coupled(v):
                x, _ = block_solve(Aug2x2, v, M=prec_aug,
                                   tol=cfg.inner.tolerance,
                                   reduction=cfg.inner.reduction,
                                   max_steps=cfg.inner.max_steps,
                                   stats=self.stats)
                return x

            prec = al_preconditioner_ideal(
                layout, aug_inv_coupled, ops["Ct_lin"], ops["M_lin"],
                ops["inv_w"], gamma_1)

        parts = dict(system_operator=system_operator, prec=prec,
                     A1=ops["A1"], gmg11=gmg11, gmg22=gmg22,
                     A22_prec=A22_prec)
        self._parts[key] = parts
        self._last_parts = parts
        return parts

    def _build_solver(self, raw_rhs: bool = False,
                      max_steps: int | None = None):
        """``run(rhs_f1, rhs_f2, bc_values) -> (x, info)``, the block
        solution (float64) with the Dirichlet data lifted and restored.
        With ``raw_rhs`` it returns ``run_raw(r0, r1, r2) -> (x, info)``,
        one solve for an assembled block right-hand side (no lifting, no
        final boundary overwrite): the correction solve of
        :meth:`solve_refined`.  ``max_steps`` caps the outer steps (default
        ``cfg.outer.max_steps``, read when the solver is built)."""
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

        n_fg = self.fg_space.n_dofs

        def run(rhs_f1, rhs_f2, bc_values):
            b0 = dirichlet_rhs(parts["A1"], rhs_f1, free, bc_values)
            b = layout.concat((b0, rhs_f2, torch.zeros(
                n_fg, dtype=b0.dtype, device=b0.device)))
            x, info = solve_core(b)
            u, u2, lam = layout.split(x)
            u = torch.where(free, u, bc_values)
            return layout.concat((u, u2, lam)), info

        return run

    # -- solve --------------------------------------------------------------

    def solve(self) -> int:
        """Build the solver of the current γ's (once) and run it; returns the
        outer iterations.  ``results`` records them with convergence, the
        solve and build seconds, the host syncs and the inner CG iterations
        (``inner_iterations``)."""
        modified = self.cfg.use_modified_AL_preconditioner
        key = (round(self.gamma_bg, 12), round(self.gamma_imm, 12), modified)
        x, info = self.session.solve(
            "modified" if modified else "ideal", key, self._build_solver,
            self.rhs_f1, self.rhs_f2, self.bc_values)
        self.u, self.u2, self.lam = self.layout.split(x)
        self.results.update(
            dofs_background=self.space.n_dofs,
            dofs_immersed=self.fg_space.n_dofs,
            outer_iterations=int(info.iterations),
            converged=bool(info.converged), residual=float(info.residual),
            gamma=self.gamma_bg)
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
        solves on the device (float64 Krylov solvers on V-cycles in
        ``dtype``, float32 on the card); the true residual of the 3x3 block
        system is evaluated in float64 on the host
        (:class:`..ops.host_ref.HostEllipticSystem`) and the loop runs until
        it reaches ``tol_abs`` under the guard of
        :func:`..utils.refine.guarded_refinement`.

        Returns ``(u, u2, lam, history)``: float64 NumPy iterates and the
        accepted true residual norms.  ``results`` records the total outer
        iterations, the final residual, the accepted steps, convergence, the
        seconds of the loop, of the device corrections and of the host
        residuals, and the host syncs
        (:meth:`.session.SolveSession.refine`).  The host system and the
        correction solver are built once per :meth:`setup` (on the operators
        :meth:`solve` built)."""
        (u, u2, lam), history = self.session.refine(
            HostEllipticSystem,
            lambda: split_correction(self.layout,
                                     self.build_correction_solver()),
            self.layout.sizes, torch.float64, ("u", "u2", "lam"), tol_abs,
            max_refine)
        self.results.update(dofs_background=self.space.n_dofs,
                            dofs_immersed=self.fg_space.n_dofs)
        return u, u2, lam, history

    # -- diagnostics --------------------------------------------------------

    def constraint_residual(self) -> float:
        """||C u - M u2||_inf (elliptic_interface.cc:973-984)."""
        r = self.C.mv(self.u) - self.M.mv(self.u2)
        return float(torch.max(torch.abs(r)))

    def cct_condition_estimate(self, max_steps: int = 200):
        """cond(CCᵀ) and the full-rank assert (elliptic_interface.cc:986-1009)."""
        b = torch.ones(self.fg_space.n_dofs, dtype=torch.float64,
                       device=self.device)
        _, info, (al, be) = cg(lambda v: self.C.mv(self.C.rmv(v)), b,
                               tol=1e-12, max_steps=max_steps,
                               track_tridiag=True)
        assert bool(info.converged), "CCt does not have full rank."
        return cg_condition_number(al, be, info.iterations)

    def errors(self):
        """L2/H1 errors against the analytical solution (convergence
        study)."""
        return (l2_error(self.space, self.u, exact_solution),
                h1_error(self.space, self.u, exact_gradient))

    # -- studies over gammas and cycles ---------------------------------------

    def parameter_study(self):
        """γ sweep on the initial grids; returns (best_gamma, iters list)
        (elliptic_interface.cc:1088-1128)."""
        cfg = self.cfg
        gammas = np.linspace(cfg.start_gamma, cfg.end_gamma, cfg.n_steps_gamma)
        self.setup(0)
        iters = []
        for g in gammas:
            self.gamma_bg = float(g)
            self.gamma_imm = float(g)
            iters.append(self.solve())
        best = float(gammas[int(np.argmin(iters))])
        self.gamma_bg = best
        self.gamma_imm = best
        return best, iters

    def run(self):
        cfg = self.cfg
        if cfg.do_parameter_study and cfg.use_modified_AL_preconditioner:
            best, _ = self.parameter_study()
            self.results["optimal_gamma"] = best
        for cycle in range(cfg.n_refinement_cycles):
            self.setup(cycle)
            its = self.solve()
            row = dict(cells=self.grid.n_cells,
                       dof_background=self.space.n_dofs,
                       dof_immersed=self.fg_space.n_dofs,
                       gamma=self.gamma_bg,
                       outer_iterations=its)
            if cfg.do_convergence_study:
                l2, h1 = self.errors()
                row["L2"] = l2
                row["H1"] = h1
            if cfg.do_sanity_checks:
                row["constraint_residual"] = self.constraint_residual()
            self.table.add_row(**row)
            if cfg.use_modified_AL_preconditioner and cfg.use_sqrt_2_rule:
                self.gamma_bg /= np.sqrt(2.0)
                self.gamma_imm /= np.sqrt(2.0)
        if cfg.do_convergence_study:
            self.table.evaluate_rates(["L2", "H1"])
        return self.table
