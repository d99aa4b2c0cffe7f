"""The elasticity interface problem of the PyTorch port against the JAX
package, in float64 on the CPU: 3D at background refinement 2 and immersed
refinement 1 (golden 18 of ``tests/test_elasticity.py``) at its stopping
rule and to a tight tolerance, the local elasticity matrix, the host float64
residual for both W, ``from_prm`` and the entry point.  The setup state is
carried across by ``state_from_jax`` with the Lanczos start vectors of both
hierarchies injected; the results table's configuration, the 2D variant and
the refined solves have files of their own
(``test_torch_elasticity_{table,2d,refine}.py``), as the suite runs under
pytest-xdist's ``--dist loadfile``."""

import inspect

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.core.fe import FE as JFE
from fictitious_domain_al_preconditioners_tpu.models import elasticity as jel
from fictitious_domain_al_preconditioners_tpu.ops.assembly import \
    elasticity_block_local as j_local
from fictitious_domain_al_preconditioners_tpu.ops.host_ref import \
    HostElasticitySystem as JHost
from fictitious_domain_al_preconditioners_torch.core.fe import FE as TFE
from fictitious_domain_al_preconditioners_torch.models import elasticity as tel
from fictitious_domain_al_preconditioners_torch.ops.assembly import \
    elasticity_block_local as t_local
from fictitious_domain_al_preconditioners_torch.ops.host_ref import \
    HostElasticitySystem as THost
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax
from test_torch_stokes import jax_normal, level_sizes

torch.set_num_threads(1)

# tests/test_elasticity.py's goldens
GOLDEN = {"small": 18, "table0": 23, "2d": 17}


def small(mod, **kw):
    """``tests/test_elasticity.py::test_3d_modified_al``'s configuration."""
    cfg = mod.ElasticityInterfaceConfig(
        initial_background_refinement=2, initial_immersed_refinement=1,
        use_fixed_iterations=True, **kw)
    cfg.outer.tolerance = 1e-9
    return cfg


def table(mod):
    """The results table's configuration with the tests' tolerance 1e-9."""
    cfg = mod.ElasticityInterfaceConfig(use_fixed_iterations=True)
    cfg.outer.tolerance = 1e-9
    return cfg


def carried_arrays(jp):
    """The reference problem's setup state after ``setup()``."""
    C, dim = jp.Cs, jp.cfg.dim
    return dict(
        problem="elasticity", rhs_f1=np.asarray(jp.rhs_f1),
        rhs_f2=np.asarray(jp.rhs_f2), free=np.asarray(jp.free),
        bg_dofs=np.asarray(C.bg_dofs), bg_phi=np.asarray(C.bg_phi),
        imm_dofs=np.asarray(C.imm_dofs), imm_psi=np.asarray(C.imm_psi),
        jxw=np.asarray(C.jxw), imm_cell_dofs=np.asarray(jp.M.row_dofs),
        m_local=np.asarray(jp.M.local),
        lanczos_starts=[jax_normal(n) for n in level_sizes(jp.space, dim)],
        lanczos_starts_a22=[jax_normal(n) for n in
                            level_sizes(jp.fg_gridspace, dim)])


def port_problem(jp, cfg_kw, cycle=0):
    """The port's problem of the same configuration on the reference's
    carried setup state (CPU, float64)."""
    tp = tel.ElasticityInterfaceProblem(cfg_kw(tel), device="cpu")
    tp.setup(cycle)
    return tp.load_state(state_from_jax(carried_arrays(jp), "cpu",
                                        torch.float64))


def block_solution(prob):
    return np.concatenate([np.asarray(x, dtype=np.float64)
                           for x in (prob.u, prob.u2, prob.lam)])


def check_solve(cfg_kw, golden, cycle=0, rel=1e-5):
    """Solve ``cfg_kw``'s configuration in both packages, the port on the
    reference's carried state: the reference's count and golden, solutions
    within ``rel`` of the reference's max, the constraint residual within
    1%.
    Returns the port's problem.

    At the goldens' stopping rule (a reduction of 1e-6) the two iterates
    agree to a few 1e-6 only: the inner CGs stop at an absolute 1e-2, so a
    rounding-level change of an inner residual can move where one stops,
    and the outer solve ends before that difference is gone (the port's own
    band and element routes of the same level matrix differ as much).  At a
    tight tolerance they agree to 1e-8 (:func:`test_tight_solve_matches`)."""
    golden_check = golden is not None
    jp = jel.ElasticityInterfaceProblem(cfg_kw(jel))
    jp.setup(cycle)
    jp.solve()
    tp = port_problem(jp, cfg_kw, cycle)
    tp.solve()
    rj, rt = jp.results, tp.results
    if golden_check:
        assert rj["outer_iterations"] == golden
    assert rt["outer_iterations"] == rj["outer_iterations"]
    assert rt["converged"] and rj["converged"]
    xj, xt = block_solution(jp), block_solution(tp)
    assert np.abs(xt - xj).max() <= rel * np.abs(xj).max()
    assert rt["dofs_background"] == rj["dofs_background"]
    # the constraint residual sits at the same stopping level
    assert tp.constraint_residual() == pytest.approx(
        jp.constraint_residual(), rel=1e-2, abs=1e-12)
    assert tp.constraint_residual() < 1e-6
    assert rt["host_syncs"] > rt["outer_iterations"]
    return tp


def test_small_3d_matches_reference():
    tp = check_solve(small, GOLDEN["small"])
    assert tp.results["dofs_background"] == 3 * 5 ** 3
    assert tp.results["dofs_immersed"] == 3 * 3 ** 3
    # one level each (4 cells per axis do not coarsen); the AL term of the
    # 4-cell background reaches past the band's half-width
    assert tp.results["gmg_routes"] == {"a11": ["element"], "a22": ["band"]}


def test_tight_solve_matches():
    """The same problem to a reduction of 1e-13: equal counts (36) and
    solutions within 1e-8."""
    def tight(mod):
        cfg = small(mod)
        cfg.outer.tolerance = cfg.outer.reduction = 1e-13
        return cfg

    tp = check_solve(tight, None, rel=1e-8)
    assert tp.results["outer_iterations"] == 36


@pytest.mark.parametrize("cycle", [0, 1])
def test_al_reach_is_the_products_extent(cycle):
    """``al_reach`` (from the coupling table) is the band half-width of
    γ·Cᵀdiag(w)C (from the SpGEMM), and ``band_plane_keys`` counts its
    planes, on both levels of the results table's configuration."""
    from fictitious_domain_al_preconditioners_torch.ops.coupling import \
        build_coupling
    from fictitious_domain_al_preconditioners_torch.ops.sparse import (
        COO, spgemm_ctwc)
    from fictitious_domain_al_preconditioners_torch.ops.sparse_band import (
        al_reach, band_plane_keys)

    tp = tel.ElasticityInterfaceProblem(table(tel), device="cpu").setup(cycle)
    w = 1.0 / tp.M.diag_host() ** 2
    sp = tp.space
    for level in range(2):
        C = build_coupling(sp, tp.fg_space, order=2, device="cpu")
        al = spgemm_ctwc(COO.from_coupling(C), w)
        offs = {tuple(int(x) for x in o) for o in np.stack(
            [al.cols % sp.n_dofs // s % m - al.rows % sp.n_dofs // s % m
             for s, m in zip(np.cumprod([1] + list(sp.n_points_1d[:-1])),
                             sp.n_points_1d)], axis=1)}
        assert al_reach(sp, C) == max(abs(x) for o in offs for x in o) == 2
        assert band_plane_keys(sp, al, 1) == {(0, 0) + o for o in offs}
        sp = sp.coarse_space()


@pytest.mark.parametrize("dim", [2, 3])
def test_local_matrix_matches_reference(dim):
    h = np.array([0.3, 0.2, 0.25][:dim])
    a = np.asarray(j_local(JFE(dim, 1), h, 2, 2.0, 1.0))
    b = t_local(TFE(dim, 1), h, 2, 2.0, 1.0)
    assert np.abs(b - a).max() <= 1e-14 * np.abs(a).max()
    assert np.abs(b - b.T).max() <= 1e-14 * np.abs(b).max()


@pytest.mark.parametrize("diag_w", [True, False])
def test_host_residual_matches_reference(diag_w):
    """``HostElasticitySystem`` of both packages at one random iterate: the
    same block residuals to 1e-12 relative, for both W."""
    def cfg_kw(mod):
        return small(mod, use_diagonal_inverse=diag_w)

    jp = jel.ElasticityInterfaceProblem(cfg_kw(jel))
    jp.setup()
    tp = port_problem(jp, cfg_kw)
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(n) for n in tp.layout.sizes]
    for rj, rt in zip(JHost(jp).residual(*xs), THost(tp).residual(*xs)):
        assert np.abs(rt - rj).max() <= 1e-12 * np.abs(rj).max()


# an inline copy of the JAX package's elasticity parameters (the reference's
# parameters_elliptic_interface/elasticity.prm, as models/elasticity.py of
# the JAX package reads it)
ELASTICITY_PRM = """
subsection Elliptic Interface Problem
  set FE degree background = 1
  set FE degree immersed = 1
  set Coupling quadrature order = 5
  set Homogeneous Dirichlet boundary ids = 0, 1, 2, 3, 4, 5
  set lambda background = 2
  set lambda immersed = 20
  set mu background = 1
  set mu immersed = 10
  set f = 1
  set f_2 = 2
  set Use fixed (inner) iterations = true
  subsection AL preconditioner
    set Use modified AL preconditioner = true
    set Use diagonal inverse = false
    set gamma fluid = 10
    set gamma solid = 0.01
  end
  subsection Grid generation
    set Background grid generator = hyper_cube
    set Background grid generator arguments = -1.25: 1.25: true
    set Immersed grid generator = hyper_rectangle
    set Immersed grid generator arguments = -0.65, -0.3, -0.4: 0.65, 0.3, 0.4: false
  end
  subsection Refinement and remeshing
    set Initial background refinement = 3
    set Initial immersed refinement = 2
  end
  subsection Outer solver control
    set Max steps = 1000
    set Tolerance = 1e-10
    set Reduction = 1e-6
  end
  subsection Inner solver control
    set Max steps = 10000
    set Tolerance = 1e-2
    set Reduction = 1e-20
  end
  subsection Iteration number control
    set Max steps = 100
    set Tolerance = 1e-2
  end
end
"""


def test_from_prm_matches_reference():
    cj = jel.ElasticityInterfaceConfig.from_prm(ELASTICITY_PRM)
    ct = tel.ElasticityInterfaceConfig.from_prm(ELASTICITY_PRM)
    for name in cj.__dataclass_fields__:
        a, b = getattr(cj, name), getattr(ct, name)
        if name in ("outer", "inner", "iteration_number"):
            assert vars(a) == vars(b), name
        else:
            assert a == b, name
    assert ct.lambda_immersed == 20.0 and ct.mu_immersed == 10.0
    assert ct.coupling_quadrature_order == 5
    assert ct.use_fixed_iterations and ct.gamma_AL_immersed == 0.01
    assert ct.arguments_for_immersed_grid.startswith("-0.65")


def test_entry_point_defaults_to_the_card():
    """The problem runs on CUDA unless the caller asks for the CPU; without
    a card, setup raises instead of falling back to the CPU; a Q2
    background sets up (it raised "not ported yet" before the port took
    it)."""
    sig = inspect.signature(tel.ElasticityInterfaceProblem.__init__)
    assert sig.parameters["device"].default == "cuda"
    prob = tel.ElasticityInterfaceProblem(small(tel))
    assert prob.device.type == "cuda" and prob.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            prob.setup()
    cfg = small(tel)
    cfg.background_space_degree = 2
    prob = tel.ElasticityInterfaceProblem(cfg, device="cpu").setup()
    assert prob.layout.sizes[0] == 3 * 9 ** 3
