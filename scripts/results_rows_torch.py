"""The rows of the H100 results table (tables/results_h100.md): each row's
configuration and stopping rule, and the function that measures one row in
the calling process.  scripts/make_results_table_torch.py runs them, one
subprocess a row; scripts/measure_family_torch.py a family in one process.

A cached row is stale when this file or a file of the port that produces it
changes (``make_results_table_torch.source_hash``).
"""

from __future__ import annotations

import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CIRCLE = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")
ELLIPTIC_PRM = os.path.join(ROOT, "parameters",
                            "elliptic_interface_modified.prm")
# the locally refined rows: chip_smoke.py's ADAPTIVE_FILES at ADAPTIVE_PAIR,
# the flower also at (11, 12), and ADAPTIVE_STOKES_2D / _3D, each with one
# local refinement step near Γ
ADAPTIVE_FILES = {"circle_f0_g1": "parameters/circle/circle_f0_g1.prm",
                  "flower_f1_g1": "parameters/flower/flower_f1_g1.prm",
                  "square_f1_g1": "parameters/square/square_f1_g1.prm"}

# the model file each kind solves through; every other file of the package
# but cli.py is shared and produces every row
FAMILY_MODEL = {
    "laplace": "immersed_laplace.py", "refined": "immersed_laplace.py",
    "rational": "immersed_laplace.py", "adaptive": "immersed_laplace.py",
    "elliptic": "elliptic_interface.py",
    "gamma_study": "elliptic_interface.py",
    "convergence_study": "elliptic_interface.py",
    "stokes": "stokes.py", "stokes3d": "stokes.py",
    "adaptive_stokes": "stokes.py", "adaptive_stokes3d": "stokes.py",
    "nitsche": "nitsche_bcs.py", "elasticity": "elasticity.py",
}


# -- configurations (scripts/make_results_table.py:22-246) -------------------

def laplace_config(ref, rhs, value, solver, tolerance):
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceConfig

    cfg = ImmersedLaplaceConfig(
        initial_refinement=ref, initial_embedded_refinement=ref,
        embedded_configuration=CIRCLE, embedding_rhs=(rhs, ""),
        embedded_value=(value, ""), solver=solver)
    if solver == "augmented":
        cfg.use_operator_form = cfg.use_diagonal_inverse = True
    cfg.schur.tolerance = tolerance
    cfg.schur.reduction = 1e-6
    return cfg


def flagship_config(ref, tolerance=3e-5):
    """The laplace rows (:22-53): the circle with smooth data, augmented in
    operator form with W = diag(M); at refinement 13 the FGMRES basis is
    capped at 12 vectors (:38-40)."""
    cfg = laplace_config(ref, "8*pi^2*sin(2*pi*x)*sin(2*pi*y)",
                         "sin(2*pi*x)*sin(2*pi*y)", "augmented", tolerance)
    if ref >= 13:
        cfg.fgmres_restart = 12
    return cfg


def elliptic_config(prm=None):
    """The elliptic rows (:56-85): modified AL, β₂ = 1e3, γ = 10 / 1e-2,
    fixed inner iterations, outer 3e-5 / 1e-5; or the configuration of a
    parameter file."""
    from fictitious_domain_al_preconditioners_torch.models import \
        EllipticInterfaceConfig

    if prm is not None:
        return EllipticInterfaceConfig.from_prm(prm)
    cfg = EllipticInterfaceConfig(
        initial_background_refinement=5, initial_immersed_refinement=3,
        beta_2=1e3, use_modified_AL_preconditioner=True,
        gamma_AL_background=10.0, gamma_AL_immersed=1e-2,
        use_fixed_iterations=True)
    cfg.outer.tolerance = 3e-5
    cfg.outer.reduction = 1e-5
    return cfg


def stokes_config(pair, spacedim, delta_refinement=0):
    """The Stokes rows (:88-124): IBStokesAL with grad-div and
    W = diag(M_Γ)⁻², outer 3e-4 / 1e-5; in 3D the sphere with g = (-1, 1,
    0) and body force (1, 0, 0)."""
    from fictitious_domain_al_preconditioners_torch.models.stokes import (
        ALControl, StokesConfig)

    ref, eref = (int(x) for x in pair.split(":"))
    cfg = StokesConfig(spacedim=spacedim, initial_refinement=ref,
                       initial_embedded_refinement=eref,
                       al=ALControl(grad_div_stabilization=True,
                                    inverse_diag_square=True))
    if spacedim == 3:
        cfg.dirichlet_ids = (0, 1, 2, 3, 4, 5)
        cfg.body_force = ("1;0;0", "")
        cfg.dirichlet_bc = ("0;0;0", "")
        cfg.embedded_value = ("-1;1;0", "")
    cfg.outer.tolerance = 3e-4
    cfg.outer.reduction = 1e-5
    cfg.delta_refinement = delta_refinement
    return cfg


def elasticity_config():
    """The elasticity rows (:222-246): fixed inner iterations, outer 3e-5 /
    1e-5."""
    from fictitious_domain_al_preconditioners_torch.models import \
        ElasticityInterfaceConfig

    cfg = ElasticityInterfaceConfig(use_fixed_iterations=True)
    cfg.outer.tolerance = 3e-5
    cfg.outer.reduction = 1e-5
    return cfg


def adaptive_config(arg):
    """A shipped immersed_laplace file (``stem:embedding:embedded``) with its
    one local refinement step, under the laplace rows' rule."""
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceConfig

    stem, ref, eref = arg.split(":")
    cfg = ImmersedLaplaceConfig.from_prm(
        os.path.join(ROOT, ADAPTIVE_FILES[stem]))
    cfg.initial_refinement, cfg.initial_embedded_refinement = int(ref), \
        int(eref)
    cfg.schur.tolerance, cfg.schur.reduction = 3e-5, 1e-6
    return cfg


# -- one row -----------------------------------------------------------------

class Meter:
    """Setup and build seconds, the peak device memory and the kernel
    launches of one row."""

    def __init__(self, key, device):
        import torch
        from fictitious_domain_al_preconditioners_torch.ops import kernels

        self.key, self.device, self.extra = key, torch.device(device), {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        kernels.reset_launch_counts()
        self.t0 = time.perf_counter()

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def set_up(self, dofs):
        self.extra["setup_seconds"] = time.perf_counter() - self.t0
        print(f"{self.key}: set up {dofs} dofs in "
              f"{self.extra['setup_seconds']:.1f} s", flush=True)

    def warm(self, prob, what, build_key="build_seconds",
             outer="outer_iterations"):
        self.sync()
        self.extra["build_seconds"] = prob.results.get(build_key)
        print(f"{self.key}: warm {what} after "
              f"{time.perf_counter() - self.t0:.1f} s: "
              f"{prob.results.get(outer)} outer iterations", flush=True)

    def timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    def entry(self, row):
        import torch
        from fictitious_domain_al_preconditioners_torch.ops import kernels

        peak = (torch.cuda.max_memory_allocated(self.device) / 1e9
                if self.device.type == "cuda" else None)
        return dict(row=list(row), peak_gb=peak,
                    row_seconds=time.perf_counter() - self.t0,
                    launches={k: v for k, v in kernels.LAUNCHES.items() if v},
                    **self.extra)


def _laplace_row(key, cfg, device, refined):
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem

    m = Meter(key, device)
    prob = ImmersedLaplaceProblem(cfg, device=device).setup()
    m.set_up(f"{prob.space.n_dofs:,} + {prob.imm_space.n_dofs:,}")
    if refined:
        prob.solve_refined(tol_abs=1e-10)
        m.warm(prob, "solve_refined", "refine_build_seconds")
        (u, lam, hist), dt = m.timed(
            lambda: prob.solve_refined(tol_abs=1e-10))
        r = prob.results
        return m.entry((prob.space.n_dofs, prob.imm_space.n_dofs,
                        r["outer_iterations"], r["refine_steps"], hist[-1],
                        dt, r["converged"]))
    prob.solve()
    m.warm(prob, "solve")
    _, dt = m.timed(prob.solve)
    return m.entry((prob.space.n_dofs, prob.imm_space.n_dofs,
                    prob.results["outer_iterations"], dt,
                    prob.constraint_residual()))


def _refined_row(key, make, device, tol, dofs, outer="outer_iterations"):
    """Set up, then a warm and a timed ``solve_refined(tol)``; returns the
    meter, the problem and the fmt_refined row (``dofs(prob)``: the row's
    two dof counts; ``outer``: the results' key of the total outer
    iterations)."""
    m = Meter(key, device)
    prob = make()
    m.set_up(" + ".join(f"{n:,}" for n in prob.layout.sizes))
    prob.solve_refined(tol_abs=tol)
    m.warm(prob, "solve_refined", "refine_build_seconds", outer)
    out, dt = m.timed(lambda: prob.solve_refined(tol_abs=tol))
    r = prob.results
    row = (*dofs(prob), r[outer], r["refine_steps"],
           out[-1][-1], dt, r["converged"])
    return m, prob, row


def _gamma_study(key, steps, device):
    from fictitious_domain_al_preconditioners_torch.models import \
        EllipticInterfaceProblem

    cfg = elliptic_config(ELLIPTIC_PRM)
    cfg.n_steps_gamma = int(steps)
    m = Meter(key, device)
    prob = EllipticInterfaceProblem(cfg, device=device)
    (best, iters), dt = m.timed(prob.parameter_study)
    gammas = np.linspace(cfg.start_gamma, cfg.end_gamma, cfg.n_steps_gamma)
    return m.entry((prob.space.n_dofs, prob.fg_space.n_dofs, best,
                    [float(g) for g in gammas], [int(i) for i in iters],
                    dt))


def _convergence_study(key, cycles, device):
    from fictitious_domain_al_preconditioners_torch.models import \
        EllipticInterfaceProblem

    cfg = elliptic_config(ELLIPTIC_PRM)
    cfg.do_convergence_study = True
    cfg.n_refinement_cycles = int(cycles)
    m = Meter(key, device)
    prob = EllipticInterfaceProblem(cfg, device=device)
    table, dt = m.timed(prob.run)

    def plain(v):
        if v is None or isinstance(v, str):
            return v
        return int(v) if isinstance(v, (int, np.integer)) else float(v)

    return m.entry(([{k: plain(v) for k, v in row.items()}
                     for row in table.rows], dt))


def compute_row(kind, arg, device="cuda"):
    """One row, measured in this process: ``{"row": [...], "setup_seconds",
    "build_seconds", "peak_gb", "row_seconds", "launches"}``."""
    from fictitious_domain_al_preconditioners_torch import models as M

    key = f"{kind}:{arg}"
    if kind == "laplace":
        return _laplace_row(key, flagship_config(int(arg)), device, False)
    if kind == "refined":
        return _laplace_row(key, flagship_config(int(arg), 1e-5), device,
                            True)
    if kind == "rational":
        return _laplace_row(key, laplace_config(int(arg), "0", "1",
                                                "rational", 3e-5),
                            device, False)
    if kind == "adaptive":
        return _laplace_row(key, adaptive_config(arg), device, False)
    if kind == "gamma_study":
        return _gamma_study(key, arg, device)
    if kind == "convergence_study":
        return _convergence_study(key, arg, device)
    if kind in ("stokes", "stokes3d", "adaptive_stokes",
                "adaptive_stokes3d", "elliptic", "elasticity"):
        if kind == "elliptic":
            def make():
                return M.EllipticInterfaceProblem(
                    elliptic_config(), device=device).setup(int(arg))
        elif kind == "elasticity":
            def make():
                return M.ElasticityInterfaceProblem(
                    elasticity_config(), device=device).setup(int(arg))
        else:
            def make():
                return M.StokesProblem(stokes_config(
                    arg, 3 if kind.endswith("3d") else 2,
                    1 if kind.startswith("adaptive") else 0),
                    device=device).setup()
        m, _, row = _refined_row(
            key, make, device, 1e-8 if "stokes" in kind else 1e-10,
            lambda p: (p.results["dofs_background"],
                       p.results["dofs_immersed"]))
        return m.entry(row)
    if kind == "nitsche":
        m, prob, row = _refined_row(
            key, lambda: M.NitscheProblem(
                M.NitscheConfig(use_manufactured_solution=True),
                device=device).setup(int(arg)),
            device, 1e-10, lambda p: (p.results["dofs_u"],
                                      p.results["dofs_lambda"]), "outer_its")
        return m.entry(row + (prob.results["inner_cg_per_outer"],))
    raise ValueError(f"unknown row kind {kind!r}")
