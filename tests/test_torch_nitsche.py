"""The nitsche problem (boundary-multiplier Dirichlet conditions) of the
PyTorch port against the JAX package, in float64 on the CPU: the
manufactured study at initial refinement 3, cycles 0-2 (goldens 7, 6, 6 of
``tests/test_nitsche.py``, and the L2 rate), with the total of inner CG
iterations; constant Dirichlet data; the DG0 multiplier; the host float64
residual; ``from_prm``; the entry point.  The setup state is carried across
by ``state_from_jax`` with the Lanczos start vectors of the bulk hierarchy
injected; the refined solve has a file of its own
(``test_torch_nitsche_refine.py``), as the suite runs under pytest-xdist's
``--dist loadfile``."""

import inspect
import os

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models import \
    nitsche_bcs as jnit
from fictitious_domain_al_preconditioners_tpu.ops.host_ref import \
    HostNitscheSystem as JHost
from fictitious_domain_al_preconditioners_torch.models import \
    nitsche_bcs as tnit
from fictitious_domain_al_preconditioners_torch.ops.host_ref import \
    HostNitscheSystem as THost
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax
from test_torch_stokes import jax_normal, level_sizes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_nitsche.py::test_manufactured_convergence
GOLDEN = (7, 6, 6)


def carried_arrays(jp):
    """The reference problem's setup state after ``setup()``."""
    C = jp.C
    return dict(
        problem="nitsche", rhs_f=np.asarray(jp.rhs_f),
        rhs_g=np.asarray(jp.rhs_g), bg_dofs=np.asarray(C.bg_dofs),
        bg_phi=np.asarray(C.bg_phi), imm_dofs=np.asarray(C.imm_dofs),
        imm_psi=np.asarray(C.imm_psi), jxw=np.asarray(C.jxw),
        points=np.asarray(C.points), imm_cell_dofs=np.asarray(jp.M.row_dofs),
        m_local=np.asarray(jp.M.local),
        lanczos_starts=[jax_normal(n) for n in level_sizes(jp.space, 1)])


def port_problem(jp, cfg_kw, cycle=0):
    """The port's problem of the same configuration on the reference's
    carried setup state (CPU, float64)."""
    tp = tnit.NitscheProblem(cfg_kw(tnit), device="cpu").setup(cycle)
    return tp.load_state(state_from_jax(carried_arrays(jp), "cpu",
                                        torch.float64))


def manufactured(mod, **kw):
    base = dict(initial_refinement=3, use_manufactured_solution=True)
    base.update(kw)
    return mod.NitscheConfig(**base)


def solve_pair(cfg_kw, cycle=0):
    """One configuration solved by both packages, the port on the
    reference's carried state: ``(jax_problem, port_problem)`` with the
    outer and inner counts and the solutions checked equal."""
    jp = jnit.NitscheProblem(cfg_kw(jnit))
    jp.setup(cycle)
    jp.solve()
    tp = port_problem(jp, cfg_kw, cycle)
    tp.solve()
    rj, rt = jp.results, tp.results
    assert rt["converged"] and rj["converged"]
    assert rt["outer_its"] == rj["outer_its"]
    assert rt["inner_cg_total"] == rj["inner_cg_total"]
    assert rt["dofs_u"] == rj["dofs_u"]
    assert rt["dofs_lambda"] == rj["dofs_lambda"]
    xj = np.concatenate([np.asarray(jp.u), np.asarray(jp.lam)])
    xt = np.concatenate([tp.u.numpy(), tp.lam.numpy()])
    assert np.abs(xt - xj).max() <= 1e-8 * np.abs(xj).max()
    assert rt["host_syncs"] > rt["outer_its"]
    return jp, tp


@pytest.mark.parametrize("cycle", [0, 1, 2])
def test_manufactured_cycle_matches_reference(cycle):
    jp, tp = solve_pair(manufactured, cycle)
    assert abs(tp.results["outer_its"] - GOLDEN[cycle]) <= 2
    assert tp.results["inner_cg_per_outer"] >= 1.0
    lj, hj = jp.errors()
    lt, ht = tp.errors()
    assert lt == pytest.approx(lj, rel=1e-8)
    assert ht == pytest.approx(hj, rel=1e-8)


def test_manufactured_study_rate():
    """``run()`` on the port's own setup: the convergence table's counts
    within the goldens' bounds and an L2 rate above 1.6."""
    cfg = manufactured(tnit, n_refinement_cycles=3)
    table = tnit.NitscheProblem(cfg, device="cpu").run()
    its = [r["outer_its"] for r in table.rows]
    assert all(abs(g - i) <= 2 for g, i in zip(GOLDEN, its)), its
    l2 = [r["L2_u"] for r in table.rows]
    assert np.log2(l2[-2] / l2[-1]) > 1.6, l2
    assert all(r["inner_cg_total"] > 0 for r in table.rows)


def test_constant_dirichlet_data():
    """u = g = 1 with f = 1: the exact solution of -Δu + u = 1 is u = 1."""
    def cfg_kw(mod):
        return mod.NitscheConfig(initial_refinement=4, rhs=("1", ""),
                                 dirichlet_data=("1", ""))

    _, tp = solve_pair(cfg_kw)
    np.testing.assert_allclose(tp.u.numpy(), 1.0, atol=1e-7)


def test_dg0_multiplier():
    def cfg_kw(mod):
        return manufactured(mod, initial_refinement=4, multiplier_degree=0,
                            use_discontinuous_multiplier=True)

    _, tp = solve_pair(cfg_kw)
    assert tp.results["outer_its"] < 60
    assert tp.results["dofs_lambda"] == 4 * 16


def test_host_residual_matches_reference():
    """``HostNitscheSystem`` of both packages at one random iterate: the
    same block residuals to 1e-12 relative."""
    jp = jnit.NitscheProblem(manufactured(jnit, initial_refinement=4))
    jp.setup(0)
    tp = port_problem(jp, lambda m: manufactured(m, initial_refinement=4))
    rng = np.random.default_rng(3)
    u = rng.standard_normal(tp.layout.sizes[0])
    lam = rng.standard_normal(tp.layout.sizes[1])
    for rj, rt in zip(JHost(jp).residual(u, lam),
                      THost(tp).residual(u, lam)):
        assert np.abs(rt - rj).max() <= 1e-12 * np.abs(rj).max()
    # the consistent augmentation of the right-hand side is not zero for
    # g = 1
    def cfg_kw(mod):
        return mod.NitscheConfig(initial_refinement=3,
                                 dirichlet_data=("1", ""))

    jp = jnit.NitscheProblem(cfg_kw(jnit))
    jp.setup(0)
    tp = port_problem(jp, cfg_kw)
    bj, bt = JHost(jp).rhs(), THost(tp).rhs()
    assert np.abs(bj[0]).max() > 1.0
    for a, b in zip(bj, bt):
        assert np.abs(b - a).max() <= 1e-12 * np.abs(a).max()


def test_from_prm_matches_reference():
    path = os.path.join(ROOT, "parameters", "nitsche.prm")
    cj = jnit.NitscheConfig.from_prm(path)
    ct = tnit.NitscheConfig.from_prm(path)
    for name in cj.__dataclass_fields__:
        a, b = getattr(cj, name), getattr(ct, name)
        if name in ("outer", "inner"):
            assert vars(a) == vars(b), name
        else:
            assert a == b, name
    assert ct.outer.tolerance == 1e-8 and ct.inner.reduction == 1e-10


def test_entry_point_defaults_to_the_card():
    """The problem runs on CUDA unless the caller asks for the CPU; without
    a card, setup raises instead of falling back to the CPU."""
    sig = inspect.signature(tnit.NitscheProblem.__init__)
    assert sig.parameters["device"].default == "cuda"
    prob = tnit.NitscheProblem(manufactured(tnit))
    assert prob.device.type == "cuda" and prob.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            prob.setup(0)
