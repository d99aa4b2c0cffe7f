"""The Stokes problem of the PyTorch port against the JAX package, in
float64 on the CPU: IBStokesAL at 4:5 with the grad-div block and diagonal W
(golden 29, ``tests/test_stokes.py``), the host float64 residual of the 3x3
system, ``from_prm``, the entry point and the unported option.  The setup
state is carried across by ``state_from_jax`` with the Lanczos start vectors
of the velocity hierarchy injected; the other solve configurations have a
file each (``test_torch_stokes_*.py``), as the suite runs under
pytest-xdist's ``--dist loadfile``."""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models import stokes as jstokes
from fictitious_domain_al_preconditioners_tpu.ops.host_ref import \
    HostStokesSystem as JHost
from fictitious_domain_al_preconditioners_torch.models import stokes as tstokes
from fictitious_domain_al_preconditioners_torch.ops.host_ref import \
    HostStokesSystem as THost
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_stokes.py: TestIBStokesAL2D's goldens
GOLDEN = {"grad_div": 29, "disc_pressure": 37, "fine": 32}
DIAG_W = dict(grad_div_stabilization=True, inverse_diag_square=True)


def make_config(mod, al=None, outer=None, **kw):
    """``tests/test_stokes.py::config_2d`` for either package's module;
    ``al`` holds ALControl's fields, ``outer`` OuterControl's."""
    base = dict(spacedim=2, initial_refinement=4,
                initial_embedded_refinement=5, solver="IBStokesAL")
    base.update(kw)
    cfg = mod.StokesConfig(al=mod.ALControl(**(al or {})), **base)
    for k, v in (outer or {}).items():
        setattr(cfg.outer, k, v)
    return cfg


def config_3d(mod, **kw):
    """The results table's 3D configuration (``scripts/
    make_results_table.py:104-112``): sphere of radius 0.1, g = (-1, 1, 0),
    body force (1, 0, 0), Dirichlet on all six faces, outer 3e-4 / 1e-5."""
    base = dict(spacedim=3, dirichlet_ids=(0, 1, 2, 3, 4, 5),
                body_force=("1;0;0", ""), dirichlet_bc=("0;0;0", ""),
                embedded_value=("-1;1;0", ""))
    base.update(kw)
    return make_config(mod, al=DIAG_W,
                       outer=dict(tolerance=3e-4, reduction=1e-5), **base)


def jax_normal(n):
    """The reference's Lanczos start vector of an n-entry level,
    ``jax.random.normal(PRNGKey(0), (n,))``."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                        dtype=jnp.float64))


def level_sizes(sp, n_comp):
    """Entries of every level vector of the velocity hierarchy, fine first
    (``precond/gmg.py``'s coarsening: while every axis has an even number
    of cells and at least 8)."""
    sizes = []
    while True:
        sizes.append(n_comp * sp.n_dofs)
        if any(n % 2 for n in sp.grid.ncells) or min(sp.grid.ncells) < 8:
            return sizes
        sp = sp.coarse_space()


def inject_lanczos(tp):
    tp.lanczos_start = lambda i, n: jax_normal(n)
    return tp


def carried_arrays(jp):
    """The reference problem's setup state after ``setup()``."""
    C = jp.Cs
    return dict(
        rhs_u=np.asarray(jp.rhs_u), rhs_g=np.asarray(jp.rhs_g),
        bc_values=np.asarray(jp.bc_values), free=np.asarray(jp.free),
        bg_dofs=np.asarray(C.bg_dofs), bg_phi=np.asarray(C.bg_phi),
        imm_dofs=np.asarray(C.imm_dofs), imm_psi=np.asarray(C.imm_psi),
        jxw=np.asarray(C.jxw), imm_cell_dofs=np.asarray(jp.M_imm_s.row_dofs),
        m_local=np.asarray(jp.M_imm_s.local),
        p_cell_dofs=np.asarray(jp.Mp.row_dofs),
        mp_local=np.asarray(jp.Mp.local),
        lanczos_starts=[jax_normal(n) for n in level_sizes(
            jp.vel_space, jp.cfg.spacedim)])


def port_problem(jp, cfg_kw):
    """The port's problem of the same configuration on the reference's
    carried setup state (CPU, float64)."""
    tp = tstokes.StokesProblem(cfg_kw(tstokes), device="cpu").setup()
    return tp.load_state(state_from_jax(carried_arrays(jp), "cpu",
                                        torch.float64))


def block_solution(prob):
    return np.concatenate([np.asarray(x, dtype=np.float64)
                           for x in (prob.u, prob.p, prob.lam)])


def reference_solve(cfg_kw):
    jp = jstokes.StokesProblem(cfg_kw(jstokes))
    jp.setup()
    jp.solve()
    return jp


def check_solve(jp, cfg_kw, golden=None):
    """Solve ``cfg_kw``'s configuration in the port on ``jp``'s state: the
    reference's outer count (and golden), solutions equal to 1e-8 of the
    reference's max, the same constraint residual.  Returns the port's
    problem."""
    tp = port_problem(jp, cfg_kw)
    tp.solve()
    ij = jp.results["outer_iterations"]
    if golden is not None:
        assert ij == golden
    assert tp.results["outer_iterations"] == ij
    assert tp.results["converged"] and jp.results["converged"]
    xj, xt = block_solution(jp), block_solution(tp)
    assert np.abs(xt - xj).max() <= 1e-8 * np.abs(xj).max()
    assert tp.results["dofs_background"] == jp.results["dofs_background"]
    assert tp.results["dofs_immersed"] == jp.results["dofs_immersed"]
    assert tp.constraint_residual() == pytest.approx(
        jp.constraint_residual(), rel=1e-6, abs=1e-13)
    assert tp.results["host_syncs"] > tp.results["outer_iterations"]
    return tp


def grad_div(mod):
    return make_config(mod, al=DIAG_W)


@pytest.fixture(scope="module")
def reference_grad_div():
    return reference_solve(grad_div)


def test_grad_div_diag_w_matches_reference(reference_grad_div):
    tp = check_solve(reference_grad_div, grad_div, GOLDEN["grad_div"])
    # the 2D hierarchy's routes: at 4:5 the Γ-band's coupling reaches past
    # the band's 4 lattice points on the fine level, the coarse levels are
    # band stencils
    assert tp.results["gmg_routes"] == ["element", "band", "band"]


def test_own_setup_matches_reference(reference_grad_div):
    """The port's own setup (grids, blocks, coupling, right-hand sides)
    gives the reference's count and solution with only the Lanczos
    vectors injected."""
    jp = reference_grad_div
    tp = inject_lanczos(tstokes.StokesProblem(grad_div(tstokes),
                                              device="cpu")).setup()
    for a, b in ((tp.rhs_u, jp.rhs_u), (tp.rhs_g, jp.rhs_g),
                 (tp.bc_values, jp.bc_values)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-14 * max(1.0, np.abs(b).max()))
    np.testing.assert_array_equal(tp.free.numpy(), np.asarray(jp.free))
    tp.solve()
    assert tp.results["outer_iterations"] == GOLDEN["grad_div"]
    xj, xt = block_solution(jp), block_solution(tp)
    assert np.abs(xt - xj).max() <= 1e-8 * np.abs(xj).max()


@pytest.mark.parametrize("diag_w", [True, False])
@pytest.mark.parametrize("grad_div_stab", [True, False])
def test_host_system_matches_reference(diag_w, grad_div_stab):
    """HostStokesSystem's float64 residual and right-hand side equal the
    JAX package's on the same random iterate, for both W and both velocity
    blocks."""
    def cfg_kw(mod):
        return make_config(mod, al=dict(grad_div_stabilization=grad_div_stab,
                                        inverse_diag_square=diag_w))

    jp = jstokes.StokesProblem(cfg_kw(jstokes))
    jp.setup()
    tp = port_problem(jp, cfg_kw)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(n) for n in tp.layout.sizes]
    rj = np.concatenate(JHost(jp).residual(*xs))
    rt = np.concatenate(THost(tp).residual(*xs))
    assert np.abs(rt - rj).max() <= 1e-12 * np.abs(rj).max()
    bj = np.concatenate(JHost(jp).rhs())
    bt = np.concatenate(THost(tp).rhs())
    assert np.abs(bt - bj).max() <= 1e-12 * np.abs(bj).max()


@pytest.mark.parametrize("spacedim", [2, 3])
def test_from_prm_matches_reference(spacedim):
    path = os.path.join(ROOT, "parameters", "stokes_al.prm")
    text = open(path).read()
    if spacedim == 3:
        text = text.replace("Distributed Lagrange<1,2>",
                            "Distributed Lagrange<2,3>")
    tc = tstokes.StokesConfig.from_prm(text, spacedim=spacedim)
    jc = jstokes.StokesConfig.from_prm(text, spacedim=spacedim)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.solver == "IBStokesAL" and tc.spacedim == spacedim
    assert (tc.initial_refinement, tc.initial_embedded_refinement) == (5, 6)
    assert tc.al.inverse_diag_square and tc.al.grad_div_stabilization
    assert tc.al.tolerance == 1e-2 and tc.outer.reduction == 1e-12
    if spacedim == 2:
        assert dataclasses.asdict(tstokes.StokesConfig.from_prm(path)) == \
            dataclasses.asdict(jc)


def test_entry_point_defaults_to_the_card():
    """The problem and the new assembly functions run on CUDA unless asked
    for the CPU; without a card, setup raises instead of falling back."""
    from fictitious_domain_al_preconditioners_torch.ops import assembly

    for fn in (tstokes.StokesProblem.__init__, assembly.rhs_vector,
               assembly.imm_rhs):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    prob = tstokes.StokesProblem(grad_div(tstokes))
    assert prob.device.type == "cuda" and prob.dtype == torch.float32
    assert prob.OP_DTYPE == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            prob.setup()


def test_delta_refinement_raises():
    """``delta_refinement`` sets up on the locally refined tree, and its
    mesh-size guard raises where the refined cells are smaller than the
    immersed mesh's (stokes_immersed_boundary.cc:497-503)."""
    prob = tstokes.StokesProblem(make_config(tstokes, delta_refinement=1),
                                 device="cpu").setup()
    assert prob.grid.max_level == 5 and hasattr(prob.vel_space, "fold_of")
    coarse = tstokes.StokesProblem(
        make_config(tstokes, delta_refinement=1,
                    initial_embedded_refinement=3), device="cpu")
    with pytest.raises(ValueError, match="mesh-size compatibility"):
        coarse.setup()
