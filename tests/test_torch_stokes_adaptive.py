"""The Stokes problem with local refinement near Γ in the PyTorch port
against the JAX package, in float64 on the CPU, each package on its own
setup with the JAX package's Lanczos start vectors injected: 3D
Taylor-Hood at 2 + 1 and 2D Q2-P1disc with the cellwise pressure on the
quadtree (``tests/test_adaptive.py:273-374``).  Equal outer counts,
velocity, pressure and multiplier within 1e-8 of the reference's max (in
2D also on the reference's carried setup state), the host float64
residual of the 3x3 system to 1e-12, and the 2D ``solve_refined(1e-8)``
in both packages: equal refinement steps and outer iterations, the
refined solutions within 1e-8 of the reference's max."""

import numpy as np
import torch

from fictitious_domain_al_preconditioners_tpu.models import stokes as jstokes
from fictitious_domain_al_preconditioners_tpu.ops.host_ref import \
    HostStokesSystem as JHost
from fictitious_domain_al_preconditioners_torch.core.adaptive import \
    AdaptiveDGPSpace
from fictitious_domain_al_preconditioners_torch.models import stokes as tstokes
from fictitious_domain_al_preconditioners_torch.ops.host_ref import \
    HostStokesSystem as THost
from fictitious_domain_al_preconditioners_torch.utils.carry import (
    gmg_level_sizes, state_from_jax)
from test_torch_stokes import block_solution, inject_lanczos, jax_normal

torch.set_num_threads(1)

SOL_TOL = 1e-8


def config_3d(mod):
    cfg = mod.StokesConfig(
        spacedim=3, initial_refinement=2, initial_embedded_refinement=1,
        delta_refinement=1, dirichlet_ids=(0, 1, 2, 3, 4, 5),
        body_force=("1;0;0", ""), dirichlet_bc=("0;0;0;0", ""),
        embedded_value=("-.1;.1;0", ""),
        al=mod.ALControl(grad_div_stabilization=True,
                         inverse_diag_square=True))
    cfg.outer.tolerance = 1e-6
    return cfg


def config_2d(mod):
    return mod.StokesConfig(
        spacedim=2, initial_refinement=4, initial_embedded_refinement=5,
        delta_refinement=1, use_disc_pressure=True,
        al=mod.ALControl(grad_div_stabilization=True,
                         inverse_diag_square=True))


def solve_both(cfg_kw):
    jp = jstokes.StokesProblem(cfg_kw(jstokes))
    jp.setup()
    jp.solve()
    tp = inject_lanczos(tstokes.StokesProblem(cfg_kw(tstokes),
                                              device="cpu")).setup()
    tp.solve()
    assert tp.results["outer_iterations"] == jp.results["outer_iterations"]
    assert tp.results["converged"] and jp.results["converged"]
    assert tp.results["dofs_background"] == jp.results["dofs_background"]
    xj, xt = block_solution(jp), block_solution(tp)
    assert np.abs(xt - xj).max() <= SOL_TOL * np.abs(xj).max()
    assert all(r == "element" for r in tp.results["gmg_routes"])
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal(n) for n in tp.layout.sizes]
    rj = np.concatenate(JHost(jp).residual(*xs))
    rt = np.concatenate(THost(tp).residual(*xs))
    assert np.abs(rt - rj).max() <= 1e-12 * np.abs(rj).max()
    return jp, tp


def test_3d_taylor_hood_matches_reference():
    jp, tp = solve_both(config_3d)
    assert tp.grid.max_level == 3 and tp.vel_space.n_constrained_cells > 0
    assert len(tp.results["gmg_routes"]) == 2


def test_2d_disc_pressure_matches_reference():
    jp, tp = solve_both(config_2d)
    assert isinstance(tp.p_space, AdaptiveDGPSpace)
    assert tp.constraint_residual() < 1e-6
    # the reference's setup state carried across, with the Lanczos start
    # vectors of the tree's hierarchy
    C = jp.Cs
    arrays = dict(
        rhs_u=np.asarray(jp.rhs_u), rhs_g=np.asarray(jp.rhs_g),
        bc_values=np.asarray(jp.bc_values), free=np.asarray(jp.free),
        bg_dofs=np.asarray(C.bg_dofs), bg_phi=np.asarray(C.bg_phi),
        imm_dofs=np.asarray(C.imm_dofs), imm_psi=np.asarray(C.imm_psi),
        jxw=np.asarray(C.jxw), imm_cell_dofs=np.asarray(jp.M_imm_s.row_dofs),
        m_local=np.asarray(jp.M_imm_s.local),
        p_cell_dofs=np.asarray(jp.Mp.row_dofs),
        mp_local=np.asarray(jp.Mp.local),
        lanczos_starts=[jax_normal(n)
                        for n in gmg_level_sizes(tp.vel_space, 2)])
    tc = tstokes.StokesProblem(config_2d(tstokes), device="cpu").setup()
    tc.load_state(state_from_jax(arrays, "cpu", torch.float64))
    tc.solve()
    assert tc.results["outer_iterations"] == jp.results["outer_iterations"]
    xj = block_solution(jp)
    assert np.abs(block_solution(tc) - xj).max() <= SOL_TOL * np.abs(xj).max()
    _, _, _, history = tp.solve_refined(tol_abs=1e-8)
    _, _, _, jhistory = jp.solve_refined(tol_abs=1e-8)
    assert tp.results["converged"] and jp.results["converged"]
    assert (tp.results["refine_steps"], tp.results["outer_iterations"]) == \
        (jp.results["refine_steps"], jp.results["outer_iterations"])
    assert history[-1] <= 1e-8 and jhistory[-1] <= 1e-8
    xj = block_solution(jp)
    assert np.abs(block_solution(tp) - xj).max() <= SOL_TOL * np.abs(xj).max()
