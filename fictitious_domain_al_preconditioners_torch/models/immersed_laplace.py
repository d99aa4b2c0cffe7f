"""Immersed-boundary Poisson problem with a Lagrange-multiplier constraint on
an embedded curve Γ (the flagship DLM problem).

Counterpart of
``fictitious_domain_al_preconditioners_tpu.models.immersed_laplace``:

    -Δu = f in Ω,   u = g on Γ,   u = g_D on ∂Ω
    [ K   Cᵀ ] [u]   [f]
    [ C   0  ] [λ] = [g]

Solver modes (``cfg.solver``, immersed_laplace.cc:502-951):

- ``augmented`` (the paper's method): outer FGMRES (CGS2) on
  ``[[Aug, Cᵀ], [C, 0]]`` with the AL preconditioner; ``Aug⁻¹`` is an inner
  CG preconditioned by a lattice GMG V-cycle that re-discretizes the AL
  term on every level.  In operator form (``use_operator_form``) the AL
  term is the particle mass γ/h_Γ·Σ_q φφᵀ JxW and W = diag(M) or M; in the
  explicit form it is γ·CᵀW⁻¹C with W = diag(M)² (the compact dense block
  of :meth:`..ops.coupling.Coupling.compact_al`) or W = M² (matrix-free in
  the operator, its diagonal surrogate on the GMG levels, as the
  reference's AMG is built, immersed_laplace.cc:711-715).
- ``CG``: exact Schur complement ``S = C K⁻¹ Cᵀ`` by CG.
- ``ELMAN_triang``: BFBt block-triangular preconditioner, right GMRES.
- ``rational``: ``diag(K⁻¹, (−Δ_Γ)^{-1/2})`` with AAA poles; MINRES in
  float64, FGMRES in float32 (MINRES stagnates there).

The last three share ``K⁻¹``: a tight GMG-preconditioned CG on the
constrained stiffness.  Every inner vector is an (ny, nx) lattice tensor; the
flat dof vector is a view of the same buffer.

With ``use_bf16_multigrid`` the augmented solver's V-cycle runs in
bfloat16: on the lattice a level whose Γ-band is interior is K2 in its
bf16-storage form (the same operator and fused Chebyshev sweeps, the
vectors and planes in bf16, float32 arithmetic), any other level K1's
bf16-storage form plus the masked compact AL block in bf16 with the
unfused Chebyshev; on the element form every level holds its stiffness
and compact AL block in bf16, while the inner CG and the outer FGMRES stay
in the working dtype.  The multiplier is continuous of ``embedded_space_degree``
1 or 2, or DG0 for 0; on the lattice its degree changes C, W and the
right-hand side, not K2's particle planes, which depend on the Γ
quadrature only.
:meth:`ImmersedLaplaceProblem.solve_refined` drives the augmented system to
a true float64 residual (``ops.host_ref``) by iterative refinement over
correction solves in the working dtype (``utils.refine``).

On CUDA the kernels carry the lattice work: K2 (``fused_augmented_2d``)
applies the augmented operator (``op``) and smooths (``pre``/``post``) on
every level of the operator form whose Γ-band is interior, and smooths
``K⁻¹``'s levels in its no-patch form; K1 (``masked_laplace_2d``) is the
constrained stiffness of ``K⁻¹``, of a coarse level whose band touches ∂Ω,
of the operator and every level of the explicit form (beside the masked
compact AL block, with the unfused Chebyshev smoother), in either dtype of
the V-cycle; K6 (``laplace_stencil_2d``, through
``LatticeOps.laplace``) is the unconstrained stiffness that lifts the
Dirichlet data.  On the CPU the same wrappers run their plain PyTorch
versions.

:meth:`ImmersedLaplaceProblem.build_sharded_solver` runs the augmented
solve over several ranks, in every configuration :meth:`solve` takes: the
lattice cut into row blocks (``parallel.mesh``), the kernels on each rank's
block, or the element form's flat vectors cut into ranges; the coarse
levels and the multiplier replicated.

Those are the lattice path's: a uniform Q1 background with Dirichlet
conditions on all four sides.  Every other background takes the element
form (immersed_laplace.py:283-295, 1111-1138 of the reference), and no
kernel of this repo is on it: local refinement near Γ (``delta_refinement >
0``, a 2:1-balanced quadtree with hanging nodes folded into the cell dof
lists, ``core.adaptive``), ``embedding_space_degree != 1``, and Dirichlet
conditions on some sides only.  There the stiffness is a
:class:`..ops.operators.CellMatrix` (a :class:`..ops.operators.CellMatrixSum`
on a tree), the constrained operators are ``m*A(m*x) + (1-m)*x`` on flat
vectors, the AL term is the compact dense block of
:meth:`..ops.coupling.Coupling.compact_al` (particle or explicit) or, for
the explicit form's outer operator with W = M², the matrix-free γ·CᵀW⁻¹C,
and the GMG is :func:`..precond.gmg.build_gmg_flat` (a tree coarsens by
truncation, the transfers tabulate the folded basis).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.adaptive import AdaptiveGrid, AdaptiveSpace
from ..core.grid import GridSpace, UniformGrid
from ..core.immersed import parametrized_curve
from ..ops.assembly import (imm_mass_matrix, imm_rhs, imm_stiffness_matrix,
                            interpolate, laplace_matrix, rhs_vector)
from ..ops.blocks import BlockLayout, block_operator
from ..ops.coupling import build_coupling
from ..ops.kernels import (AugmentedStencil2D, fused_augmented_2d,
                           masked_laplace_2d)
from ..ops.krylov import cg, cg_condition_number, fgmres, gmres, minres
from ..ops.linop import LinOp
from ..ops.operators import CellRows, constrain, dirichlet_rhs
from ..ops.host_ref import HostAugmentedSystem
from ..parallel.lattice import LatticeOps
from ..precond.al import al_preconditioner, block_solve
from ..precond.gmg import (FusedSmoother, build_gmg, build_gmg_flat,
                           build_gmg_flat_sharded, build_gmg_sharded,
                           level_spaces)
from ..precond.rational import rational_preconditioner
from ..precond.weights import (inv_diag, inv_diag_squared, inv_exact,
                               inv_squared_exact)
from ..utils.expressions import ParsedFunction
from ..utils.prm import Params, parse_prm
from ..utils.refine import CORRECTION_MAX_OUTER
from ..utils.timer import TimerOutput
from .session import SolveSession

__all__ = ["SolverControlConfig", "ImmersedLaplaceConfig",
           "ImmersedLaplaceProblem"]

# symmetric 5-plane compression of the 9-point patch: centre + the 4
# "positive" offsets (0,1), (1,0), (1,1), (1,-1), as w9[a, b] indices
_PLANES = ((1, 1), (1, 2), (2, 1), (2, 2), (2, 0))

SOLVERS = ("augmented", "CG", "ELMAN_triang", "rational")


def _k2(mode, st, *ext, **kw):
    # the kernel's entry looked up at each call, where the benchmark's call
    # wrappers (``fdal_bench/trace.py::KernelCalls``) patch it
    return fused_augmented_2d(mode, st, *ext, **kw)


def _k2_smoother(st, lam, degree, eig_ratio, run=_k2):
    """K2's fused Chebyshev smoother on the stencil ``st``: its ``smooth``,
    ``pre`` and ``post`` modes, each one call ``run(mode, st, b[, x0],
    **kw)`` (the kernel's entry, or a wrapper of it)."""
    kw = dict(lam_max=lam, degree=degree, eig_ratio=eig_ratio)
    return FusedSmoother(
        lambda b: run("smooth", st, b, **kw),
        pre=lambda b: run("pre", st, b, **kw),
        post=lambda b, x0: run("post", st, b, x0, **kw))


def _fgmres_restart(cfg, total: int) -> int:
    """The FGMRES restart of a layout of ``total`` dofs.  FGMRES keeps the
    V and Z bases, 2*restart+1 vectors: the restart is capped so that they
    fit about 6 GB on very large layouts (never engaged at the ~4-30 outer
    iterations of the augmented solve)."""
    return min(cfg.fgmres_restart, max(12, int(6e9 / (8 * max(total, 1)))))


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

    @classmethod
    def from_prm(cls, text_or_path) -> "ImmersedLaplaceConfig":
        """The configuration of a reference parameter file (a path, or the
        file's text), keys as in immersed_laplace.cc:70-233."""
        text = text_or_path
        if "\n" not in str(text_or_path):
            with open(text_or_path) as fh:
                text = fh.read()
        p = Params(parse_prm(text)).enter("Distributed Lagrange<1,2>")
        al = p.enter("AL preconditioner")
        sc = p.enter("Schur solver control")

        def fn(section, default_expr):
            sub = p.enter(section)
            return (sub.get_str("Function expression", default_expr),
                    sub.get_str("Function constants", ""))

        return cls(
            initial_refinement=p.get_int("Initial embedding space refinement", 4),
            delta_refinement=p.get_int("Local refinements steps near embedded domain", 0),
            initial_embedded_refinement=p.get_int("Initial embedded space refinement", 5),
            dirichlet_ids=tuple(p.get_int_list("Dirichlet boundary ids", (0, 1, 2, 3))),
            embedding_space_degree=p.get_int("Embedding space finite element degree", 1),
            embedded_space_degree=p.get_int("Embedded space finite element degree", 1),
            embedded_configuration_degree=p.get_int("Embedded configuration finite element degree", 1),
            coupling_quadrature_order=p.get_int("Coupling quadrature order", 3),
            use_displacement=p.get_bool("Use displacement in embedded interface", False),
            solver=p.get_str("Solver", "CG"),
            use_operator_form=al.get_bool("Use operator version", False),
            use_diagonal_inverse=al.get_bool("Use diagonal inverse", False),
            schur=SolverControlConfig(
                max_steps=sc.get_int("Max steps", 1000),
                tolerance=sc.get_float("Tolerance", 1e-12),
                reduction=sc.get_float("Reduction", 1e-12)),
            embedded_configuration=fn("Embedded configuration",
                                      "R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy"),
            embedding_rhs=fn("Embedding rhs function", "0"),
            embedded_value=fn("Embedded value", "1"),
            dirichlet_boundary=fn("Embedding Dirichlet boundary conditions",
                                  "0"),
        )


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
        self.timer = TimerOutput()
        self.results = {}
        self.stats = {"host_syncs": 0, "inner_iterations": 0}
        self.lanczos_start = None
        self.compact_blocks = []
        self.session = SolveSession(self, "immersed_laplace")

    def _element_form_triggers(self) -> list:
        """The settings that put the background in element form (no
        kernel): a locally refined grid, a degree other than 1, Dirichlet
        conditions on some sides only (immersed_laplace.py:298-300,
        418-421 of the reference)."""
        cfg = self.cfg
        return [name for name, on in (
            ("delta_refinement", cfg.delta_refinement > 0),
            ("embedding_space_degree", cfg.embedding_space_degree != 1),
            ("dirichlet_ids", set(cfg.dirichlet_ids) != {0, 1, 2, 3}))
            if on]

    @property
    def element_form(self) -> bool:
        """Whether the background takes the element form (no kernel)."""
        return bool(self._element_form_triggers())

    def _check_supported(self):
        cfg = self.cfg
        if cfg.solver not in SOLVERS:
            raise ValueError(f"unknown solver {cfg.solver!r}; one of "
                             f"{SOLVERS}")

    # -- setup --------------------------------------------------------------

    def setup(self):
        self._check_supported()
        cfg = self.cfg
        dev, dt = self.device, self.dtype
        t0 = time.perf_counter()
        with self.timer.scope("Setup grids and dofs"):
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
            kdeg = cfg.embedded_space_degree
            # a DG0 multiplier for degree 0 (immersed_laplace.py:175-178 of
            # the reference)
            self.imm_space = (self.curve.space(kdeg) if kdeg > 0 else
                              self.curve.space(0, continuous=False))
            if cfg.delta_refinement > 0:
                # refine the cells holding the Γ support points and their
                # face neighbours, delta times (immersed_laplace.cc:328-343)
                grid = AdaptiveGrid.uniform(2, cfg.initial_refinement)
                for _ in range(cfg.delta_refinement):
                    grid = grid.refine_near(self.imm_space.dof_points)
                self.grid = grid
                self.space = AdaptiveSpace(grid, cfg.embedding_space_degree)
                h_omega_min = grid.min_cell_diameter
            else:
                self.grid = UniformGrid.hyper_cube(2, 0.0, 1.0,
                                                   cfg.initial_refinement)
                self.space = GridSpace.q(self.grid,
                                         cfg.embedding_space_degree)
                h_omega_min = self.grid.cell_diameter
            # mesh-compatibility guard (immersed_laplace.cc:364-369)
            if self.curve.h_max >= h_omega_min:
                raise ValueError(
                    "The embedding grid is too refined (or the embedded grid "
                    "is too coarse): "
                    f"h_Gamma={self.curve.h_max:.3e} >= "
                    f"h_Omega={h_omega_min:.3e}")

        with self.timer.scope("Assemble system"):
            deg = cfg.embedding_space_degree
            self.K = (laplace_matrix(self.space, order=deg + 1, device=dev,
                                     dtype=dt) if self.element_form else None)
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
                ~self.space.boundary_dof_mask(list(cfg.dirichlet_ids)),
                device=dev)
            self.bc_values = interpolate(self.space, self.bc_fn, device=dev,
                                         dtype=dt)
        with self.timer.scope("Setup coupling"):
            self.C = build_coupling(self.space, self.imm_space,
                                    cfg.coupling_quadrature_order, device=dev,
                                    dtype=dt)
        self.layout = BlockLayout((self.space.n_dofs, self.imm_space.n_dofs))
        self.session.reset()
        self.results["setup_seconds"] = time.perf_counter() - t0
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
        self.session.reset()
        return self

    # -- solve ----------------------------------------------------------------

    def solve(self):
        """Build the solver of ``cfg.solver`` (once per setup) and run it.
        Returns ``(u, lam, SolveInfo)``; ``results`` records the outer
        iterations, convergence, solve seconds, host syncs and inner CG
        iterations (``inner_iterations``) of this solve."""
        key = self.cfg.solver
        build = {"augmented": self._augmented_run,
                 "CG": self._build_schur_cg,
                 "ELMAN_triang": self._build_elman,
                 "rational": self._build_rational}[key]
        u, lam, info = self.session.solve(key, key, build, self.rhs_f,
                                          self.rhs_g, self.bc_values)
        self.u, self.lam = u, lam
        self.results.update(
            outer_iterations=int(info.iterations),
            residual=float(info.residual), converged=bool(info.converged),
            dofs_background=self.space.n_dofs,
            dofs_immersed=self.imm_space.n_dofs)
        return u, lam, info

    def _level_operator(self, sp, coupling, gamma, dtype=None, w_diag=None):
        """Masked augmented operator of one lattice level: ``(op, diag,
        smoother_builder)`` for :func:`..precond.gmg.build_gmg`, and the
        level's :class:`AugmentedStencil2D` (None on a compact-AL level).

        A level of the operator form whose Γ-band is interior is K2 (``op``,
        and ``pre``/``post`` as its smoother) in the level's dtype: the
        working dtype, or bfloat16 (``dtype``, the bf16 V-cycle), where K2
        runs in bf16 storage.  The reference has no bf16 form of the fused
        kernel (``pallas_kernels.py:451-452``) and applies K1's bf16 form
        plus the masked 9-point patch with the unfused Chebyshev; K2's
        symmetric planes are that patch on an interior band.  A level whose
        band touches ∂Ω, and every level of the explicit form (``w_diag``,
        the weights of γ·Cᵀdiag(w)C), is K1 plus the masked compact AL block
        in either dtype (``_fused_masked_k`` + ``_masked_wrap`` of the
        reference, immersed_laplace.py:1100-1106, 1129-1135)."""
        dt = self.dtype
        lat = LatticeOps.for_space(sp)
        ny, nx = lat.shape
        k_diag = lat.laplace_diag()
        free = ~sp.boundary_dof_mask(list(self.cfg.dirichlet_ids))
        explicit = w_diag is not None
        pw = None if explicit else coupling.patch_w9(sp, gamma)
        if pw is not None:
            st, al_diag = self._patch_stencil(sp, pw, dtype)

            def op(x2):
                return fused_augmented_2d("op", st, x2)

            return (op, k_diag + al_diag,
                    functools.partial(_k2_smoother, st)), st

        # the explicit form, or a (coarse) level whose Γ-band touches ∂Ω:
        # the compact AL block
        al, al_diag = self._compact(coupling, gamma, w_diag, [ny, nx],
                                    dtype or dt)
        return self._masked_aug_level(lat, free, al, k_diag + al_diag), None

    def _compact(self, coupling, gamma, w_diag, shape, dtype, rows=None):
        """The compact AL block of ``coupling`` held in ``dtype``
        (``Coupling.compact_al``), or with ``rows = (first, last)`` a rank's
        rows of it (``Coupling.compact_al_rows``), recorded in
        ``compact_blocks`` with its rows, bytes and seconds."""
        t0 = time.perf_counter()
        if rows is None:
            out = coupling.compact_al(gamma, w_diag, dtype=dtype)
            m = own = out[0].rows
        else:
            out = coupling.compact_al_rows(gamma, *rows, w_diag, dtype=dtype)
            m, own = out.rows, out.p1 - out.p0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compact_blocks.append(dict(
            shape=shape, rows=m, own_rows=own,
            bytes=own * m * dtype.itemsize,
            seconds=time.perf_counter() - t0))
        return out

    def _patch_stencil(self, sp, pw, dtype=None):
        """K2's stencil of a lattice level from its Γ-band patch ``pw`` =
        ``(box, w9)`` (:meth:`..ops.coupling.Coupling.patch_w9`), its planes
        in ``dtype`` (default the working dtype; rounded through it, as
        ``patch_al_lattice`` rounds its weights), and the patch's assembled
        diagonal (flat)."""
        lat = LatticeOps.for_space(sp)
        (r0, c0, pr, pc), w9 = pw
        planes = torch.as_tensor(np.stack([w9[a, b] for a, b in _PLANES]),
                                 dtype=self.dtype,
                                 device=self.device).to(dtype or self.dtype)
        st = AugmentedStencil2D(lat.h, lat.shape, planes, pw[0])
        al_diag = np.zeros(lat.shape)
        al_diag[r0:r0 + pr, c0:c0 + pc] = w9[1, 1]
        return st, al_diag.reshape(-1)

    def _masked_aug_level(self, lat, free, al, diag):
        """``(op, diag, None)`` of a level whose operator is K1 plus the
        masked AL term ``al`` (flat in, flat out): ``K1(x) + m⊙al(m⊙x)``,
        the unfused Chebyshev as its smoother."""
        ny, nx = lat.shape
        m = torch.as_tensor(free.reshape(ny, nx), device=self.device)

        def op(x2):
            al_x = al(torch.where(m, x2, 0.0).reshape(-1)).reshape(ny, nx)
            return masked_laplace_2d(x2, lat.h) + torch.where(m, al_x, 0.0)

        return op, diag, None

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
        C_lin = self.C.as_linop()
        Ct_lin = C_lin.T
        layout = self.layout
        free = self.free
        if max_steps is None:
            max_steps = cfg.schur.max_steps
        self.compact_blocks = []   # every compact AL block formed, in order
        build = (self._augmented_flat if self.element_form
                 else self._augmented_lattice)
        Aug, aug_inv, gamma, inv_w = build()

        AA = block_operator(layout, layout, [[Aug, Ct_lin], [C_lin, None]])
        prec = al_preconditioner(layout, aug_inv, Ct_lin, inv_w, gamma)
        restart = _fgmres_restart(cfg, layout.total)

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

    def _al_form(self):
        """The AL form of ``cfg``: ``(gamma, inv_w, w_diag, coupling_for,
        fine_coupling)``.  In operator form γ is scaled by 1/h_Γ, the AL term
        is the particle mass on Γ from a coupling table of order 2k+1 on
        every level, W = diag(M) or M, ``w_diag`` None.  In the explicit
        form γ·CᵀW⁻¹C with W = diag(M)² or M² (γ not scaled); every GMG
        level carries the diagonal surrogate γ·Cᵀdiag(w)C of its own
        coupling, ``w_diag = diag(M)⁻²``, the fine level the problem's C."""
        cfg = self.cfg
        dev, dt = self.device, self.dtype
        if cfg.use_operator_form:
            gamma = cfg.gamma / self.curve.h_max
            inv_w = (inv_diag(self.M) if cfg.use_diagonal_inverse
                     else inv_exact(self.M))

            def coupling_for(sp):
                return build_coupling(
                    sp, self.imm_space,
                    order=2 * cfg.embedding_space_degree + 1, device=dev,
                    dtype=dt)

            return gamma, inv_w, None, coupling_for, coupling_for(self.space)
        m_diag = (self.M.diag_host() if hasattr(self.M, "diag_host")
                  else self.M.diag().double().cpu().numpy())
        inv_w = (inv_diag_squared(self.M) if cfg.use_diagonal_inverse
                 else inv_squared_exact(self.M))

        def coupling_for(sp):
            return build_coupling(sp, self.imm_space,
                                  cfg.coupling_quadrature_order, device=dev,
                                  dtype=dt)

        return cfg.gamma, inv_w, 1.0 / m_diag ** 2, coupling_for, self.C

    def _augmented_lattice(self):
        """The lattice path's augmented operator ``Aug`` (flat LinOp), its
        inner solve ``aug_inv`` (CG on lattice tensors, the lattice GMG
        V-cycle), γ and W⁻¹: ``(Aug, aug_inv, gamma, inv_w)``."""
        cfg = self.cfg
        dev, dt = self.device, self.dtype
        free = self.free
        shape = LatticeOps.for_space(self.space).shape
        n = self.space.n_dofs
        gmg_dt = torch.bfloat16 if cfg.use_bf16_multigrid else dt

        gamma, inv_w, w_diag, coupling_for, fine_coupling = self._al_form()

        # the fine augmented operator of the inner CG, in the working dtype
        fine_level, fine_stencil = self._level_operator(
            self.space, fine_coupling, gamma, w_diag=w_diag)
        if cfg.use_operator_form or cfg.use_diagonal_inverse:
            aug_lat = fine_level[0]
        else:
            # W = M² is not diagonal: the operator keeps the matrix-free
            # γ·CᵀW⁻¹C (immersed_laplace.py:1013-1016 of the reference)
            aug_lat = self._masked_aug_level(
                LatticeOps.for_space(self.space), free.cpu().numpy(),
                self.C.al_term(inv_w, gamma), None)[0]

        self.level_stencils = []   # per GMG level, fine first

        def op_factory(sp):
            if sp is self.space and gmg_dt == dt:
                level, st = fine_level, fine_stencil
            else:
                coupling = (fine_coupling if sp is self.space
                            else coupling_for(sp))
                level, st = self._level_operator(sp, coupling, gamma,
                                                 dtype=gmg_dt, w_diag=w_diag)
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
            x2, _ = block_solve(aug_lat, v.reshape(shape), M=gmg.apply,
                                tol=cfg.inner_tolerance,
                                max_steps=cfg.inner_max_steps,
                                stats=self.stats)
            return x2.reshape(-1)

        return Aug, aug_inv, gamma, inv_w

    def _augmented_flat(self):
        """The element-form path's ``(Aug, aug_inv, gamma, inv_w)``
        (immersed_laplace.py:952-1030, 1111-1138 of the reference without
        its lattice branches): Aug = constrain(K + AL) on flat vectors with
        the compact AL block (the particle form γ/h_Γ·Σ_q φφᵀ JxW in operator
        form, γ·Cᵀdiag(M)⁻²C in the explicit form; with W = M² the outer
        operator keeps the matrix-free γ·CᵀW⁻¹C and the GMG levels the
        diagonal surrogate), inverted by CG on the flat GMG whose levels
        re-discretize K and the AL term."""
        cfg = self.cfg
        dt = self.dtype
        free = self.free
        form = self._al_form()
        gamma, inv_w = form[:2]
        gmg_dt = torch.bfloat16 if cfg.use_bf16_multigrid else dt

        levels = {}

        def op_factory(sp):
            levels[id(sp)] = self._flat_level(sp, gmg_dt, form)
            return levels[id(sp)]

        gmg = build_gmg_flat(self.space, op_factory, free_mask=free,
                             smoother_degree=cfg.gmg_smoother_degree,
                             lanczos_start=self.lanczos_start, dtype=gmg_dt,
                             stats=self.stats)
        self._last_gmg = gmg
        if cfg.use_operator_form or cfg.use_diagonal_inverse:
            aug_raw = (levels[id(self.space)] if gmg_dt == dt
                       else self._flat_level(self.space, dt, form))[0]
        else:
            al_op = self.C.al_term(inv_w, gamma)

            def aug_raw(x):
                return self.K.mv(x) + al_op(x)

        n = self.space.n_dofs
        Aug = constrain(LinOp(aug_raw, (n, n), aug_raw), free)

        def aug_inv(v):
            x, _ = block_solve(Aug, v, M=gmg.apply, tol=cfg.inner_tolerance,
                               max_steps=cfg.inner_max_steps,
                               stats=self.stats)
            return x

        return Aug, aug_inv, gamma, inv_w

    def _level_stiffness(self, sp):
        """The element-form stiffness of a GMG level (the problem's K on
        the fine one), in the working dtype."""
        if sp is self.space:
            return self.K
        return laplace_matrix(sp, order=self.cfg.embedding_space_degree + 1,
                              device=self.device, dtype=self.dtype)

    def _flat_level(self, sp, dtype, form, rows=None):
        """``(mv, diag)`` of an element-form GMG level for
        :func:`..precond.gmg.build_gmg_flat`: K and the compact AL block
        (of the AL form ``form``, :meth:`_al_form`) held in the level's
        ``dtype``: the bf16 V-cycle's levels take and return bf16 (the
        reference passes dtype=bfloat16 to build_gmg on this path too,
        immersed_laplace.py:1192-1198).  With ``rows = (first, last)``:
        ``mv(x)`` those rows of the level's operator applied to the whole
        vector ``x`` (a rank's rows of the sharded element form)."""
        gamma, _, w_diag, coupling_for, fine_coupling = form
        K_l = self._level_stiffness(sp)
        diag = K_l.diag_host()
        K_l = K_l.astype(dtype)
        coupling = fine_coupling if sp is self.space else coupling_for(sp)
        if rows is not None:
            K_l = CellRows(K_l, *rows)
            cr = self._compact(coupling, gamma, w_diag, [sp.n_dofs], dtype,
                               rows=rows)

            def mv_rows(x):
                return K_l.mv(x) + cr.apply(x[cr.uniq])

            return mv_rows, diag + cr.diag
        al, al_diag = self._compact(coupling, gamma, w_diag, [sp.n_dofs],
                                    dtype)

        def mv(x):
            return K_l.mv(x) + al(x)

        return mv, diag + al_diag

    def build_sharded_solver(self, mesh):
        """The augmented solve over the ranks of ``mesh``
        (:func:`..parallel.mesh.make_mesh`, this process's rank): returns
        ``run(rhs_f, rhs_g, bc_values) -> (u, lam, info)`` on global
        inputs, as the JAX package's method does, to be called on every
        rank at once.  Every ``augmented`` configuration that
        :meth:`solve` takes: either AL form, either W, either V-cycle
        dtype, the lattice or the element form.

        The same solve as ``solver='augmented'`` (outer FGMRES, the AL
        preconditioner, inner CG, the GMG V-cycle) with the background cut
        into this rank's rows and the immersed side replicated (W⁻¹, the
        exact one too, applies to the whole multiplier on every rank).  On
        the lattice (:meth:`_sharded_lattice`) the rows are row blocks of
        every level down to the replicated tail; on the element form
        (:meth:`_sharded_flat`) contiguous ranges of each level's flat dof
        vector.  C sums each rank's share over the ranks
        (``Coupling.row_block``), Cᵀ scatters into each rank's rows; the
        Krylov inner products all-reduce the background part and add the
        multiplier part once.  ``u`` comes back whole on every rank,
        ``lam`` is replicated, and ``info`` is checked equal on every rank.
        The serial hierarchy is not built."""
        if mesh.device != self.device:
            raise ValueError(f"build_sharded_solver: the mesh's device "
                             f"{mesh.device} is not the problem's "
                             f"{self.device}")
        self.compact_blocks = []     # every compact AL block formed, in order
        self.sharded_levels = []     # per distributed level, fine first
        self.level_stencils = []     # per tail level
        self.sharded_outer = None    # the outer operator's own fine level
        build = (self._sharded_flat if self.element_form
                 else self._sharded_lattice)
        return build(mesh)

    def _sharded_coupling(self, mesh, first: int, last: int):
        """C on this rank's background dofs ``[first, last)``: its share
        summed over the ranks (``Coupling.row_block``), Cᵀ into its rows."""
        table = self.C.row_block(first, last, 1)
        return LinOp(lambda u: mesh.all_reduce(table.mv(u)),
                     (self.imm_space.n_dofs, last - first), table.rmv,
                     name="C")

    def _sharded_lattice(self, mesh):
        """The lattice path over row blocks (``parallel.mesh.plan_levels``):
        every distributed level runs its kernels on each rank's extended
        block.  A level of the operator form whose Γ-band is interior is K2
        (``op``, and ``pre``/``post`` as its smoother) in the level's dtype
        (bf16 storage under a bf16 V-cycle, as on one rank), its patch box
        clipped to the block (``AugmentedStencil2D.row_block``); a level of
        the explicit form or whose band touches ∂Ω K1 plus this rank's rows
        of the masked compact block (``Coupling.compact_al_rows``: its band
        entries summed over the ranks, one all-reduce an apply), both with
        the unfused Chebyshev over one halo exchange an operator call.  The
        coarse levels whose blocks would be thinner than the sweeps' halo
        form the replicated tail (:class:`..precond.gmg.ShardedGMG`).  The
        outer operator is the fine level in the working dtype (K2 ``op``
        under a bf16 V-cycle), or with W = M² K1 plus the matrix-free
        γ·CᵀW⁻¹C over the all-reduced C; K6 lifts the Dirichlet data on
        the blocks."""
        from ..parallel.mesh import (HALO, block_laplace, ext_rows, on_block,
                                     plan_levels, sweep_halo)

        cfg = self.cfg
        dt = self.dtype
        gmg_dt = torch.bfloat16 if cfg.use_bf16_multigrid else dt
        degree = cfg.gmg_smoother_degree
        gamma, inv_w, w_diag, coupling_for, fine_coupling = self._al_form()
        spaces = level_spaces(self.space)
        # by level size: build_gmg_sharded makes its own level spaces
        couplings = {sp.n_dofs: fine_coupling if i == 0 else coupling_for(sp)
                     for i, sp in enumerate(spaces)}
        lat = LatticeOps.for_space(self.space)
        depth = sweep_halo(degree)
        blocks = plan_levels(*lat.shape, mesh.size, n_levels=len(spaces),
                             depth=depth)

        def k2(mode, st, **kw):
            return lambda *ext: fused_augmented_2d(mode, st, *ext, **kw)

        def k1_plus(bl, h, al):
            # K1 on the extended block, plus ``al`` (flat rows in, flat rows
            # out) on this rank's rows
            def op(x2):
                k = on_block(mesh, bl, HALO["op"],
                             lambda e: masked_laplace_2d(e, h), x2)
                return k + al(x2.reshape(-1)).reshape(x2.shape)

            return op

        def level_on_block(sp, bl, dtype):
            """``(op, diag, smoother_builder)`` of a distributed level in
            ``dtype``, and its record for ``sharded_levels``."""
            lo, hi = bl.rows(mesh.rank)
            lat_l = LatticeOps.for_space(sp)
            k_diag = lat_l.laplace_diag()
            coupling = couplings[sp.n_dofs]
            explicit = w_diag is not None
            rec = dict(rows=[lo, hi], dtype=str(dtype).replace("torch.", ""),
                       h=lat_l.h)
            pw = None if explicit else coupling.patch_w9(sp, gamma)
            if pw is not None:
                st, al_diag = self._patch_stencil(sp, pw, dtype)
                sts = {d: st.row_block(*ext_rows(mesh, bl, d))
                       for d in (HALO["op"], depth)}
                rec.update(kind="k2", stencils=sts)

                def op(x2):
                    return on_block(mesh, bl, HALO["op"],
                                    k2("op", sts[HALO["op"]]), x2)

                def smoother_builder(lam, degree, eig_ratio):
                    if degree + 1 > depth:
                        raise ValueError(f"a degree-{degree} sweep needs a "
                                         f"halo of {degree + 1} rows, not "
                                         f"{depth}")
                    rec["lam_max"] = lam
                    return _k2_smoother(
                        sts[depth], lam, degree, eig_ratio,
                        run=lambda mode, s, *ext, **kw: on_block(
                            mesh, bl, depth, k2(mode, s, **kw), *ext))

                return (op, k_diag + al_diag, smoother_builder), rec
            ext = ext_rows(mesh, bl, HALO["op"])
            rec.update(kind="k1", ext=list(ext))
            free = ~sp.boundary_dof_mask(list(cfg.dirichlet_ids))
            # the explicit form, or a level whose Γ-band touches ∂Ω: this
            # rank's rows of the masked compact AL block
            nx = bl.nx
            cr = self._compact(coupling, gamma, w_diag, [bl.ny, nx], dtype,
                               rows=(lo * nx, hi * nx))
            m = torch.as_tensor(free[lo * nx:hi * nx], device=self.device)

            def al_rows(x):
                band = mesh.all_reduce(cr.share(torch.where(m, x, 0.0)))
                return torch.where(m, cr.apply(band), 0.0)

            return (k1_plus(bl, lat_l.h, al_rows), k_diag + cr.diag,
                    None), rec

        def block_factory(i, sp, bl):
            level, rec = level_on_block(sp, bl, gmg_dt)
            self.sharded_levels.append(rec)
            return level

        def op_factory(sp):
            level, st = self._level_operator(sp, couplings[sp.n_dofs], gamma,
                                             dtype=gmg_dt, w_diag=w_diag)
            self.level_stencils.append(st)
            return level

        gmg = build_gmg_sharded(self.space, block_factory, op_factory,
                                mesh=mesh, blocks=blocks, free_mask=self.free,
                                smoother_degree=degree,
                                lanczos_start=self.lanczos_start,
                                dtype=gmg_dt, stats=self.stats)
        fine = blocks[0]
        lo, hi = fine.rows(mesh.rank)
        nx = fine.nx
        C_lin = self._sharded_coupling(mesh, lo * nx, hi * nx)
        if not (cfg.use_operator_form or cfg.use_diagonal_inverse):
            # W = M² is not diagonal: the operator keeps the matrix-free
            # γ·CᵀW⁻¹C (immersed_laplace.py:1013-1016 of the reference)
            m = torch.as_tensor(self.free[lo * nx:hi * nx], device=self.device)

            def al_rows(x):
                al = gamma * C_lin.T(inv_w(C_lin(torch.where(m, x,
                                                                   0.0))))
                return torch.where(m, al, 0.0)

            aug_blk = k1_plus(fine, lat.h, al_rows)
            self.sharded_outer = dict(kind="k1", rows=[lo, hi], dtype=str(
                dt).replace("torch.", ""), h=lat.h,
                ext=list(ext_rows(mesh, fine, HALO["op"])))
        elif gmg_dt == dt:
            aug_blk = gmg.levels[0].op
        else:
            (aug_blk, _, _), self.sharded_outer = level_on_block(
                self.space, fine, dt)

        def k_mv(x):
            return block_laplace(mesh, fine, lat.h,
                                 x.reshape(hi - lo, nx)).reshape(-1)

        return self._sharded_outer(mesh, blocks, gmg, aug_blk, k_mv, C_lin,
                                   inv_w, gamma, (hi - lo, nx))

    def _sharded_flat(self, mesh):
        """The element form over contiguous ranges of every level's flat
        dof vector (``parallel.mesh.plan_ranges``, the partition GSPMD
        gives the JAX package's flat vectors): every operator computes this
        rank's rows on its all-gathered input, masked as a whole vector
        (the stiffness ``ops.operators.CellRows``, the compact AL block
        ``Coupling.compact_al_rows``, the transfers
        ``precond.gmg.ProlongationRows``), the unfused Chebyshev on the
        distributed levels; the levels whose ranges are thinner than
        ``parallel.mesh.FLAT_MIN_ROWS`` form the replicated tail, the last
        with the dense coarse inverse.  No kernel runs on this path, as in
        serial.  A ghost-dof halo would replace the all-gather."""
        from ..parallel.mesh import plan_ranges

        cfg = self.cfg
        dt = self.dtype
        gmg_dt = torch.bfloat16 if cfg.use_bf16_multigrid else dt
        form = self._al_form()
        gamma, inv_w = form[:2]
        blocks = plan_ranges([sp.n_dofs for sp in level_spaces(self.space)],
                             mesh.size)
        fine_rows = {}

        def block_factory(i, sp, bl):
            rows = bl.rows(mesh.rank)
            self.sharded_levels.append(dict(
                kind="element", rows=list(rows),
                dtype=str(gmg_dt).replace("torch.", "")))
            fine_rows[i] = self._flat_level(sp, gmg_dt, form, rows=rows)
            return fine_rows[i]

        def op_factory(sp):
            return self._flat_level(sp, gmg_dt, form)

        gmg = build_gmg_flat_sharded(self.space, block_factory, op_factory,
                                     mesh=mesh, blocks=blocks,
                                     free_mask=self.free,
                                     smoother_degree=cfg.gmg_smoother_degree,
                                     lanczos_start=self.lanczos_start,
                                     dtype=gmg_dt, stats=self.stats)
        fine = blocks[0]
        lo, hi = fine.rows(mesh.rank)
        C_lin = self._sharded_coupling(mesh, lo, hi)
        K_own = CellRows(self.K, lo, hi)
        if not (cfg.use_operator_form or cfg.use_diagonal_inverse):
            def aug_rows(x):
                return K_own.mv(x) + gamma * C_lin.T(inv_w(self.C.mv(x)))
        elif gmg_dt == dt:
            aug_rows = fine_rows[0][0]
        else:
            aug_rows = self._flat_level(self.space, dt, form,
                                        rows=(lo, hi))[0]
        m_full = self.free
        m_own = m_full[lo:hi]

        def gather(x):
            return mesh.all_gather_rows(x, fine.counts)

        def aug_blk(x):
            return torch.where(m_own, aug_rows(torch.where(
                m_full, gather(x), 0.0)), x)

        def k_mv(x):
            return K_own.mv(gather(x))

        return self._sharded_outer(mesh, blocks, gmg, aug_blk, k_mv, C_lin,
                                   inv_w, gamma, (hi - lo,))

    def _sharded_outer(self, mesh, blocks, gmg, aug_blk, k_mv, C_lin, inv_w,
                       gamma, shape):
        """The outer solve over this rank's rows (``shape``: the fine
        level's rows of a lattice, or of a flat vector): FGMRES on the
        block system with the AL preconditioner, whose inner CG runs on
        ``aug_blk`` preconditioned by ``gmg``, and the ``run`` of
        :meth:`build_sharded_solver`."""
        from ..parallel.mesh import inner_product, replicated

        cfg = self.cfg
        fine = blocks[0]
        lo, hi = fine.rows(mesh.rank)
        own = slice(lo * fine.nx, hi * fine.nx)
        n_own, n_imm = own.stop - own.start, self.imm_space.n_dofs
        Ct_lin = C_lin.T

        def aug_mv(x):
            return aug_blk(x.reshape(shape)).reshape(-1)

        def aug_inv(v):
            x, _ = cg(aug_blk, v.reshape(shape), M=gmg.apply,
                      tol=cfg.inner_tolerance, max_steps=cfg.inner_max_steps,
                      stats=self.stats, inner=inner_product(mesh))
            return x.reshape(-1)

        layout = BlockLayout((n_own, n_imm))
        AA = block_operator(layout, layout, [
            [LinOp(aug_mv, (n_own, n_own), aug_mv, name="Aug"), Ct_lin],
            [C_lin, None]])
        prec = al_preconditioner(layout, aug_inv, Ct_lin, inv_w, gamma)
        # the serial solve's restart, from the whole layout
        restart = _fgmres_restart(cfg, self.layout.total)
        inner = inner_product(mesh, n_own)

        def run(rhs_f, rhs_g, bc_values):
            dev = self.device
            free = self.free[own]
            bc = bc_values[own].to(dev)
            rhs_g = replicated(mesh, rhs_g)
            b0 = dirichlet_rhs(k_mv, rhs_f[own].to(dev), free, bc)
            b0 = b0 + torch.where(free, gamma * Ct_lin(inv_w(rhs_g)), 0.0)
            x, info = fgmres(AA, layout.concat((b0, rhs_g)), prec,
                             tol=cfg.schur.tolerance,
                             reduction=cfg.schur.reduction,
                             max_steps=cfg.schur.max_steps, restart=restart,
                             stats=self.stats, inner=inner)
            u, lam = layout.split(x)
            mesh.same_on_every_rank([info.iterations, info.residual,
                                     info.res0, info.converged],
                                    "the outer solve's info")
            u = mesh.all_gather_rows(torch.where(free, u, bc).reshape(shape),
                                     fine.counts)
            return u.reshape(-1), lam, info

        run.gmg, run.blocks, run.mesh = gmg, blocks, mesh
        run.flat = len(shape) == 1
        return run

    def _check_refinable(self):
        cfg = self.cfg
        if not (cfg.solver == "augmented" and cfg.use_operator_form
                and cfg.use_diagonal_inverse):
            raise NotImplementedError(
                "solve_refined: the augmented solver in operator form with "
                "W = diag(M) only; the host float64 reference "
                "(ops.host_ref.HostAugmentedSystem) applies that system "
                "alone, as the reference package's does")
        if self.element_form:
            raise NotImplementedError(
                "solve_refined: the uniform Q1 lattice with Dirichlet "
                "conditions on all sides only; the host float64 reference "
                "applies the lattice stiffness, as the reference package's "
                "does (host_ref.py:154-157)")

    def build_correction_solver(self):
        """``(b0, b1) -> (du, dlam, info)``: one AL-preconditioned FGMRES
        solve of the augmented system with a raw right-hand side, its outer
        steps capped at ``utils.refine.CORRECTION_MAX_OUTER`` (the inner
        engine of :meth:`solve_refined`)."""
        self._check_refinable()
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
        the seconds of the whole loop (``refined_seconds``), of the device
        correction solves and of the host residuals, and the host syncs
        (:meth:`.session.SolveSession.refine`).  The host system and the
        correction solver are built once per :meth:`setup`.  Operator form
        with W = diag(M) only (else ``NotImplementedError``)."""
        self._check_refinable()

        def correction():
            corr = self.build_correction_solver()

            def run(b0, b1):
                du, dlam, info = corr(b0, b1)
                return (du, dlam), info

            return run

        (u, lam), history = self.session.refine(
            HostAugmentedSystem, correction, self.layout.sizes, self.dtype,
            ("u", "lam"), tol_abs, max_refine)
        self.results.update(dofs_background=self.space.n_dofs,
                            dofs_immersed=self.imm_space.n_dofs)
        return u, lam, history

    def _k_mv(self):
        """The unconstrained fine stiffness on flat vectors (kernel K6 on
        CUDA; the element form off the lattice path), which lifts the
        Dirichlet data."""
        if self.element_form:
            return self.K.mv
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
        one.  Returns ``(K_c, K_inv)`` on flat vectors.  Off the lattice
        path K is the element form and the GMG the flat one (the
        reference's flat branch, :283-295)."""
        if self.element_form:
            return self._kg_inv_flat(reduction)
        dev, dt = self.device, self.dtype
        shape = LatticeOps.for_space(self.space).shape
        self.kinv_stencils = []   # per GMG level, fine first

        def factory(sp):
            lat = LatticeOps.for_space(sp)
            st = AugmentedStencil2D(lat.h, lat.shape, device=dev, dtype=dt)
            self.kinv_stencils.append(st)

            def op(x2):
                return masked_laplace_2d(x2, lat.h)

            return op, lat.laplace_diag(), functools.partial(_k2_smoother,
                                                             st)

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

    def _kg_inv_flat(self, reduction):
        def factory(sp):
            K_l = self._level_stiffness(sp)
            return K_l.mv, K_l.diag_host()

        gmg = build_gmg_flat(self.space, factory, free_mask=self.free,
                             lanczos_start=self.lanczos_start,
                             dtype=self.dtype, stats=self.stats)
        self._kinv_gmg = gmg
        K_c = constrain(self.K.as_linop(), self.free)

        def K_inv(v):
            x, _ = cg(K_c, v, M=gmg.apply, tol=0.0, reduction=reduction,
                      max_steps=2000, stats=self.stats)
            return x

        return K_c, K_inv

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

    def cct_condition_estimate(self, max_steps: int = 100) -> float:
        """cond(CCᵀ) from the tridiagonal of a CG solve on CCᵀ with a
        standard normal right-hand side (``default_rng(0)``), as
        immersed_laplace.cc:987-1010 reads it off the CG."""
        b = torch.as_tensor(np.random.default_rng(0).standard_normal(
            self.imm_space.n_dofs), dtype=torch.float64, device=self.device)
        _, info, (al, be) = cg(lambda v: self.C.mv(self.C.rmv(v)), b,
                               tol=1e-12, max_steps=max_steps,
                               track_tridiag=True)
        return cg_condition_number(al, be, info.iterations)

    def run(self):
        """``setup()`` then ``solve()``; returns ``results``."""
        self.setup()
        self.solve()
        return self.results
