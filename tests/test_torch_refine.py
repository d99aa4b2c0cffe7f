"""Iterative refinement of the PyTorch port against the JAX package: the
guarded refinement loop on synthetic residual/correction pairs (including
the 64x growth cap, pinned just below and just above), the float64 host
residual of the augmented system, ``solve_refined`` on the reference's own
refinement test problem, and a float32 CPU run with the bf16 V-cycle."""

import inspect

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models import (
    ImmersedLaplaceConfig as JConfig, ImmersedLaplaceProblem as JProblem)
from fictitious_domain_al_preconditioners_tpu.models.immersed_laplace import \
    SolverControlConfig as JControl
from fictitious_domain_al_preconditioners_tpu.ops.host_ref import \
    HostAugmentedSystem as JHost
from fictitious_domain_al_preconditioners_tpu.utils import refine as jrefine
from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceConfig as TConfig, ImmersedLaplaceProblem as TProblem)
from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
    import SolverControlConfig as TControl
from fictitious_domain_al_preconditioners_torch.ops.host_ref import \
    HostAugmentedSystem as THost
from fictitious_domain_al_preconditioners_torch.utils import refine as trefine
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax
from test_torch_immersed_laplace import CIRCLE, carried_arrays

torch.set_num_threads(1)


# -- the guard ---------------------------------------------------------------

def _identity_case(coef_per_call):
    """``residual(x) = b - x`` and ``correct(r) = coef * r`` with the
    coefficient of the k-th call; returns (residual, correct, sizes)."""
    b = np.linspace(1.0, 2.0, 5)
    calls = []

    def residual(x):
        return (b - x,)

    def correct(rs):
        coef = coef_per_call[min(len(calls), len(coef_per_call) - 1)]
        calls.append(1)
        return [coef * rs[0]], 3

    return residual, correct, (5,)


def _transient_case(ratio):
    """A first correction whose full and half steps both grow the true
    residual by ``ratio`` (the f32 transient the cap exists for); the next
    correction is exact.  The residual is ``b * g(t)`` along the direction
    of b, ``x = t b``, with ``g = 1`` near ``t = 0``, ``g = ratio`` for the
    half and the full first step (``t = 1/2, 1``) and ``g = 0`` beyond, where
    the second step lands (``t = 1 + ratio``)."""
    b = np.linspace(1.0, 2.0, 4)
    bb = float(b @ b)

    def residual(x):
        t = float(x @ b) / bb
        g = 1.0 if t < 0.25 else (ratio if t <= 2.0 else 0.0)
        return (g * b,)

    def correct(rs):
        return [rs[0].copy()], 5

    return residual, correct, (4,)


GUARD_CASES = {
    "exact": lambda: _identity_case([1.0]),
    "nan": lambda: _identity_case([np.nan]),
    "overshoot_half_step": lambda: _identity_case([2.0]),
    "stagnating": lambda: _identity_case([0.0]),
    "bounded_growth_then_exact": lambda: _identity_case([4.0, 1.0]),
    "growing": lambda: _identity_case([-5.0]),
    "transient_63.9x": lambda: _transient_case(63.9),
    "transient_64.1x": lambda: _transient_case(64.1),
}


def _run(mod, case, **kw):
    residual, correct, sizes = GUARD_CASES[case]()
    return mod.guarded_refinement(residual, correct, sizes, 1e-12, 10, **kw)


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_matches_reference(case):
    (xt,), ht, it_t, ct = _run(trefine, case)
    (xj,), hj, it_j, cj = _run(jrefine, case)
    assert (it_t, ct) == (it_j, cj)
    assert ht == hj
    np.testing.assert_array_equal(xt, xj)


def test_guard_growth_cap_pinned_at_64():
    """A 63.9x first-step transient is accepted (and the next, exact,
    correction converges); a 64.1x one is rejected and the loop returns the
    initial iterate.  The cap is an argument of the loop: at 65 the 64.1x
    step passes."""
    (x,), hist, _, conv = _run(trefine, "transient_63.9x")
    assert conv and len(hist) == 3
    assert hist[1] == pytest.approx(63.9 * hist[0], rel=1e-12)
    (x,), hist, iters, conv = _run(trefine, "transient_64.1x")
    assert not conv and len(hist) == 1 and iters == 5
    assert np.all(x == 0.0)
    (x,), hist, _, conv = _run(trefine, "transient_64.1x", growth_cap=65.0)
    assert conv and hist[1] == pytest.approx(64.1 * hist[0], rel=1e-12)
    assert trefine.CORRECTION_MAX_OUTER == jrefine.CORRECTION_MAX_OUTER == 64
    default = inspect.signature(TProblem.solve_refined).parameters
    assert list(default) == ["self", "tol_abs", "max_refine"]
    assert default["tol_abs"].default == 1e-10
    assert default["max_refine"].default == 12


# -- the host residual and solve_refined -------------------------------------

def smooth_config(cfg_cls, control_cls, ref=5):
    """tests/test_immersed_laplace.py::smooth_config for the augmented
    solver (operator form, W = diag(M)) with the stopping rule of its
    refinement test (:206-215)."""
    return cfg_cls(
        initial_refinement=ref, initial_embedded_refinement=ref,
        embedded_configuration=CIRCLE,
        embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
        embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
        dirichlet_boundary=("0", ""), solver="augmented",
        use_operator_form=True, use_diagonal_inverse=True,
        schur=control_cls(max_steps=1000, tolerance=1e-8, reduction=1e-8))


def _pair(ref=5):
    jp = JProblem(smooth_config(JConfig, JControl, ref))
    jp.setup()
    tp = TProblem(smooth_config(TConfig, TControl, ref), device="cpu").setup()
    tp.load_state(state_from_jax(carried_arrays(jp), "cpu", torch.float64))
    return jp, tp


def test_host_residual_matches_reference():
    jp, tp = _pair()
    rng = np.random.default_rng(5)
    u = rng.standard_normal(tp.space.n_dofs)
    lam = rng.standard_normal(tp.imm_space.n_dofs)
    jh, th = JHost(jp), THost(tp)
    for got, ref in zip(th.residual(u, lam) + th.rhs(),
                        jh.residual(u, lam) + jh.rhs()):
        assert got.dtype == np.float64
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("max_steps", [1000, 10])
def test_correction_solver_caps_outer_steps(max_steps):
    """A correction solve that cannot reach its tolerance stops at
    ``min(cfg.schur.max_steps, CORRECTION_MAX_OUTER)`` outer steps, and
    building it leaves the configuration as it was."""
    cfg = smooth_config(TConfig, TControl, 4)
    cfg.schur = TControl(max_steps=max_steps, tolerance=0.0, reduction=0.0)
    prob = TProblem(cfg, device="cpu").setup()
    corr = prob.build_correction_solver()
    assert cfg.schur.max_steps == max_steps
    rng = np.random.default_rng(2)
    b0 = torch.as_tensor(rng.standard_normal(prob.space.n_dofs))
    b1 = torch.as_tensor(rng.standard_normal(prob.imm_space.n_dofs))
    _, _, info = corr(b0, b1)
    assert info.iterations == min(max_steps, trefine.CORRECTION_MAX_OUTER)
    assert not info.converged


def test_solve_refined_matches_reference():
    """The same accepted steps and, entry by entry, the same history to
    1e-3 relative.  The last entry (about 6e-15) lies at the rounding floor
    of evaluating b - A x in float64, eps * |b| = 2.2e-16 * history[0]
    (about 7e-15), where the two packages' summation orders decide the
    digits; entries are compared to that floor in absolute terms."""
    jp, tp = _pair()
    _, _, hj = jp.solve_refined(tol_abs=1e-12)
    u, lam, ht = tp.solve_refined(tol_abs=1e-12)
    res = tp.results
    assert res["converged"] and jp.results["converged"]
    assert res["refine_steps"] == jp.results["refine_steps"]
    assert len(ht) == len(hj) and ht[-1] <= 1e-12
    floor = np.finfo(np.float64).eps * hj[0]
    for a, b in zip(ht, hj):
        assert abs(a - b) <= max(1e-3 * b, floor)
    assert u.dtype == np.float64 and u.shape == (tp.space.n_dofs,)
    assert res["host_syncs"] > res["outer_iterations"]
    assert res["correction_seconds"] + res["host_residual_seconds"] \
        <= res["solve_seconds"]


def test_float32_bf16_vcycle_refines_to_1e10():
    """Float32 corrections with the bf16 V-cycle at refinement 6 and the
    flagship's float32 stopping rule reach a true float64 residual of
    1e-10."""
    cfg = smooth_config(TConfig, TControl, 6)
    cfg.use_bf16_multigrid = True
    cfg.schur.tolerance, cfg.schur.reduction = 3e-5, 1e-6
    prob = TProblem(cfg, device="cpu", dtype=torch.float32).setup()
    u, lam, hist = prob.solve_refined(tol_abs=1e-10)
    assert prob._last_gmg.dtype == torch.bfloat16
    assert prob.results["converged"] and hist[-1] <= 1e-10
    assert prob.results["refined_residual"] == hist[-1]
    assert np.all(np.isfinite(u)) and np.all(np.isfinite(lam))
