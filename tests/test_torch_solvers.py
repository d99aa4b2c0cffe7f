"""The solver pieces of the CG, ELMAN_triang and rational modes of the
PyTorch port against the JAX package in float64: GMRES, MINRES, batched CG
and CG from a start vector on seeded systems; the AAA table of
``rational_sqrt``; the immersed stiffness and the batched ``CellMatrix``
apply; the tight K⁻¹ the three modes share; and the accuracy of the three
modes on the smooth problem."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.core.immersed import \
    parametrized_curve as j_curve
from fictitious_domain_al_preconditioners_tpu.models import (
    ImmersedLaplaceConfig as JConfig, ImmersedLaplaceProblem as JProblem)
from fictitious_domain_al_preconditioners_tpu.models.immersed_laplace import \
    SolverControlConfig as JControl
from fictitious_domain_al_preconditioners_tpu.ops import assembly as jasm
from fictitious_domain_al_preconditioners_tpu.ops import krylov as jk
from fictitious_domain_al_preconditioners_tpu.precond import rational as jr
from fictitious_domain_al_preconditioners_tpu.utils.expressions import \
    ParsedFunction as JParsed
from fictitious_domain_al_preconditioners_torch.core import parametrized_curve
from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceConfig, ImmersedLaplaceProblem)
from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
    import SolverControlConfig
from fictitious_domain_al_preconditioners_torch.ops import assembly as tasm
from fictitious_domain_al_preconditioners_torch.ops import krylov as tk
from fictitious_domain_al_preconditioners_torch.ops.assembly import l2_error
from fictitious_domain_al_preconditioners_torch.precond import rational as tr
from fictitious_domain_al_preconditioners_torch.utils import ParsedFunction
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax
from test_torch_immersed_laplace import carried_arrays, mode_config

torch.set_num_threads(1)

CIRCLE = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")


def rel(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return np.abs(t - j).max() / np.abs(j).max()


def spd(n, seed, lo=1.0, hi=20.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ np.diag(np.geomspace(lo, hi, n)) @ Q.T, rng


@pytest.mark.parametrize("restart", [50, 7])
def test_gmres(restart):
    rng = np.random.default_rng(1)
    n = 50
    A = 3.0 * np.eye(n) + 0.4 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    d = 1.0 / np.diag(A)
    tA, jA = torch.as_tensor(A), jnp.asarray(A)
    kw = dict(tol=1e-11, reduction=1e-12, max_steps=300, restart=restart)
    xt, it = tk.gmres(lambda v: tA @ v, torch.as_tensor(b),
                      lambda v: torch.as_tensor(d) * v, **kw)
    xj, ij = jk.gmres(lambda v: jA @ v, jnp.asarray(b),
                      lambda v: jnp.asarray(d) * v, **kw)
    assert it.iterations == int(ij.iterations) and it.converged
    assert rel(xt, xj) <= 1e-10


def test_minres_symmetric_indefinite():
    """A saddle-point-like symmetric indefinite system with an SPD
    preconditioner, as the rational mode's outer solve."""
    n = 80
    A, rng = spd(n, 2)
    A[n // 2:] *= -1.0                     # flip half the spectrum
    A = 0.5 * (A + A.T)
    w, V = np.linalg.eigh(A)
    A = V @ np.diag(np.where(np.arange(n) % 2, 1.0, -1.0) * np.abs(w)) @ V.T
    b = rng.standard_normal(n)
    d = 1.0 / np.abs(np.diag(A)).clip(0.5)
    tA, jA = torch.as_tensor(A), jnp.asarray(A)
    kw = dict(tol=1e-10, reduction=1e-12, max_steps=400)
    xt, it = tk.minres(lambda v: tA @ v, torch.as_tensor(b),
                       lambda v: torch.as_tensor(d) * v, **kw)
    xj, ij = jk.minres(lambda v: jA @ v, jnp.asarray(b),
                       lambda v: jnp.asarray(d) * v, **kw)
    assert it.converged and abs(it.iterations - int(ij.iterations)) <= 1
    assert rel(xt, xj) <= 1e-8
    assert np.linalg.norm(A @ xt.numpy() - b) <= 1e-8 * np.linalg.norm(b)


def test_batched_cg():
    """k shifted SPD systems A + s_i I in one batched CG, as the rational
    preconditioner's pole solves."""
    n, k = 70, 6
    A, rng = spd(n, 3, 0.01, 5.0)
    shifts = np.geomspace(1e-2, 10.0, k)
    B = rng.standard_normal((n, k))
    dinv = 1.0 / (np.diag(A)[:, None] + shifts[None, :])
    tA, jA = torch.as_tensor(A), jnp.asarray(A)
    ts, js = torch.as_tensor(shifts), jnp.asarray(shifts)
    kw = dict(tol=1e-12, reduction=1e-10, max_steps=500)
    stats = {}
    Xt, it = tk.batched_cg(lambda X: tA @ X + X * ts[None, :],
                           torch.as_tensor(B),
                           M=lambda R: torch.as_tensor(dinv) * R,
                           stats=stats, **kw)
    Xj, ij = jk.batched_cg(lambda X: jA @ X + X * js[None, :], jnp.asarray(B),
                           M=lambda R: jnp.asarray(dinv) * R, **kw)
    assert it.iterations == int(ij.iterations) and it.converged
    assert rel(Xt, Xj) <= 1e-10
    assert stats["host_syncs"] == it.iterations + 1   # one read per step


def test_cg_from_x0_and_fixed_iterations():
    A, rng = spd(50, 4)
    b, x0 = rng.standard_normal(50), rng.standard_normal(50)
    tA, jA = torch.as_tensor(A), jnp.asarray(A)
    kw = dict(tol=1e-30, max_steps=7, fixed_iters=True)
    xt, it = tk.cg(lambda v: tA @ v, torch.as_tensor(b),
                   x0=torch.as_tensor(x0), **kw)
    xj, ij = jk.cg(lambda v: jA @ v, jnp.asarray(b), x0=jnp.asarray(x0),
                   **kw)
    assert it.iterations == int(ij.iterations) == 7
    assert it.converged and bool(ij.converged)
    assert rel(xt, xj) <= 1e-12


def test_rational_sqrt_matches_reference():
    pt, rt, dt = tr.rational_sqrt()
    pj, rj, dj = jr.rational_sqrt()
    assert len(pt) == len(pj) >= 10 and np.all(pt < 0)
    np.testing.assert_allclose(pt, pj, rtol=1e-12)
    np.testing.assert_allclose(rt, rj, rtol=1e-12)
    assert dt == pytest.approx(dj, rel=1e-12)
    x = np.geomspace(1e-5, 1.0, 50)
    r = dt + np.sum(rt[None, :] / (x[:, None] - pt[None, :]), axis=1)
    assert np.abs(r - np.sqrt(x)).max() <= 1e-6


def test_immersed_stiffness_and_batched_mv():
    f = ParsedFunction(*CIRCLE)
    jf = JParsed(*CIRCLE)
    ti = parametrized_curve(lambda p: np.asarray(f(p)), 5).space(1)
    ji = j_curve(lambda p: np.asarray(jf(p)), 5).space(1)
    tA = tasm.imm_stiffness_matrix(ti, order=2, device="cpu")
    jA = jasm.imm_stiffness_matrix(ji, order=2)
    for t, j in zip(tA.to_coo(), jA.to_coo()):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-13, atol=1e-13)
    X = np.random.default_rng(5).standard_normal((ti.n_dofs, 4))
    assert rel(tA.mv(torch.as_tensor(X)), jA.mv(jnp.asarray(X))) <= 1e-13
    assert rel(tA.mv(torch.as_tensor(X[:, 1])),
               jA.mv(jnp.asarray(X[:, 1]))) <= 1e-13
    # the Laplace-Beltrami operator of a closed curve annihilates constants
    ones = torch.ones(ti.n_dofs, dtype=torch.float64)
    assert float(tA.mv(ones).abs().max()) <= 1e-10 * float(tA.diag().max())


def test_k_inverse_matches_reference():
    """``_kg_inv``: the constrained stiffness K_c is the same operator and
    the tight GMG-CG inverse agrees to its 1e-13 stopping level."""
    jp = JProblem(mode_config(JConfig, JControl, "CG", 5)).setup()
    tp = ImmersedLaplaceProblem(mode_config(
        ImmersedLaplaceConfig, SolverControlConfig, "CG", 5),
        device="cpu").setup()
    tp.load_state(state_from_jax(carried_arrays(jp), "cpu", torch.float64))
    jK, jinv = jp._kg_inv()
    tK, tinv = tp._kg_inv()
    v = np.random.default_rng(0).standard_normal(jp.space.n_dofs)
    np.testing.assert_allclose(tK(torch.as_tensor(v)).numpy(),
                               np.asarray(jK(jnp.asarray(v))), rtol=1e-13,
                               atol=1e-13 * np.abs(v).max())
    xj = np.asarray(jax.jit(jinv)(jnp.asarray(v)))
    xt = tinv(torch.as_tensor(v)).numpy()
    assert np.abs(xt - xj).max() <= 1e-12 * np.abs(xj).max()
    assert len(tp._kinv_gmg.levels) == 4
    assert all(not st.patched for st in tp.kinv_stencils)


def smooth_config(solver):
    """tests/test_immersed_laplace.py::smooth_config at refinement 5: the
    exact solution is u = sin(2πx) sin(2πy)."""
    schur = (SolverControlConfig(max_steps=300, tolerance=1e-9,
                                 reduction=1e-9)
             if solver == "ELMAN_triang" else SolverControlConfig())
    return ImmersedLaplaceConfig(
        initial_refinement=5, initial_embedded_refinement=5,
        embedded_configuration=CIRCLE,
        embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
        embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""), solver=solver,
        schur=schur)


@pytest.mark.parametrize("solver", ["CG", "ELMAN_triang", "rational"])
def test_smooth_solution_accuracy(solver):
    """tests/test_immersed_laplace.py::TestOtherSolvers on the port."""
    prob = ImmersedLaplaceProblem(smooth_config(solver), device="cpu").setup()
    u, _, info = prob.solve()
    assert info.converged
    err = l2_error(prob.space, u, lambda p: np.sin(2 * np.pi * p[:, 0])
                   * np.sin(2 * np.pi * p[:, 1]))
    assert err < 6e-3
    assert prob.results["host_syncs"] > info.iterations
