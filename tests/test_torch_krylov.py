"""Krylov solvers, Chebyshev smoothing and the GMG V-cycle of the PyTorch
port against the JAX package in float64 (Lanczos start vectors injected from
JAX, whose ``jax.random`` draw torch cannot reproduce)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models import (
    ImmersedLaplaceConfig as JConfig, ImmersedLaplaceProblem as JProblem)
from fictitious_domain_al_preconditioners_tpu.ops import krylov as jk
from fictitious_domain_al_preconditioners_tpu.ops.pallas_kernels import (
    masked_laplace_2d as j_masked_laplace_2d)
from fictitious_domain_al_preconditioners_tpu.precond.chebyshev import \
    chebyshev as j_chebyshev
from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceConfig as TConfig, ImmersedLaplaceProblem as TProblem)
from fictitious_domain_al_preconditioners_torch.ops import krylov as tk
from fictitious_domain_al_preconditioners_torch.ops.kernels import \
    masked_laplace_2d
from fictitious_domain_al_preconditioners_torch.precond.chebyshev import \
    chebyshev as t_chebyshev
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax

torch.set_num_threads(1)


def rel(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return np.abs(t - j).max() / np.abs(j).max()


def jax_normal(n):
    """The reference's Lanczos start vector (ops/krylov.py:188-191)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                        dtype=jnp.float64))


def gmg_level_sizes(space):
    sizes = [space.n_dofs]
    while all(n % 2 == 0 for n in space.grid.ncells) \
            and min(space.grid.ncells) // 2 >= 4:
        space = space.coarse_space()
        sizes.append(space.n_dofs)
    return sizes


def carried_arrays(jp):
    C = jp.C
    return dict(
        rhs_f=np.asarray(jp.rhs_f), rhs_g=np.asarray(jp.rhs_g),
        bc_values=np.asarray(jp.bc_values), free=np.asarray(jp.free),
        bg_dofs=np.asarray(C.bg_dofs), bg_phi=np.asarray(C.bg_phi),
        imm_dofs=np.asarray(C.imm_dofs), imm_psi=np.asarray(C.imm_psi),
        jxw=np.asarray(C.jxw), m_diag=np.asarray(jp.M.diag()),
        lanczos_starts=[jax_normal(n) for n in gmg_level_sizes(jp.space)])


def spd_system(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.geomspace(1.0, 20.0, n)) @ Q.T
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("reduction", [None, 1e-8])
def test_cg(reduction):
    A, b = spd_system(100, 0)
    d = 1.0 / np.diag(A)
    tA, jA = torch.as_tensor(A), jnp.asarray(A)
    kw = dict(tol=1e-10, reduction=reduction, max_steps=200)
    xt, it = tk.cg(lambda v: tA @ v, torch.as_tensor(b),
                   M=lambda v: torch.as_tensor(d) * v, **kw)
    xj, ij = jk.cg(lambda v: jA @ v, jnp.asarray(b),
                   M=lambda v: jnp.asarray(d) * v, **kw)
    assert it.iterations == int(ij.iterations) and it.converged
    assert rel(xt, xj) <= 1e-12


@pytest.mark.parametrize("restart", [50, 7])
def test_fgmres(restart):
    rng = np.random.default_rng(1)
    n = 50
    A = 3.0 * np.eye(n) + 0.4 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    d = 1.0 / np.diag(A)
    tA, jA = torch.as_tensor(A), jnp.asarray(A)
    kw = dict(tol=1e-11, reduction=1e-12, max_steps=300, restart=restart)
    xt, it = tk.fgmres(lambda v: tA @ v, torch.as_tensor(b),
                       lambda v: torch.as_tensor(d) * v, **kw)
    xj, ij = jk.fgmres(lambda v: jA @ v, jnp.asarray(b),
                       lambda v: jnp.asarray(d) * v, **kw)
    assert it.iterations == int(ij.iterations) and it.converged
    assert rel(xt, xj) <= 1e-10


def test_lanczos_with_injected_start():
    A, _ = spd_system(80, 2)
    tA, jA = torch.as_tensor(A), jnp.asarray(A)
    lt = tk.lanczos_max_eig(lambda v: tA @ v, 80, steps=10, v0=jax_normal(80))
    lj = jk.lanczos_max_eig(lambda v: jA @ v, 80, steps=10)
    assert abs(lt - lj) <= 1e-12 * abs(lj)


def test_chebyshev():
    shape, h = (33, 33), (1 / 32, 1 / 32)
    jop = j_masked_laplace_2d(h, shape)
    diag_inv = np.full(shape, 1.0 / (8.0 / 3.0))
    b = np.random.default_rng(3).standard_normal(shape)
    xt = t_chebyshev(lambda x: masked_laplace_2d(x, h),
                     torch.as_tensor(diag_inv), 1.9)(torch.as_tensor(b))
    xj = j_chebyshev(jop, jnp.asarray(diag_inv), 1.9)(jnp.asarray(b))
    assert rel(xt, xj) <= 1e-12


def flagship(mod, ref):
    cfg = mod(initial_refinement=ref, initial_embedded_refinement=ref,
              embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                      "R=.2, Cx=.4, Cy=.4"),
              solver="augmented", use_operator_form=True,
              use_diagonal_inverse=True)
    return cfg


def test_gmg_vcycle_matches_reference():
    jp = JProblem(flagship(JConfig, 5)).setup()
    jp._augmented_run()
    tp = TProblem(flagship(TConfig, 5), device="cpu").setup()
    tp.load_state(state_from_jax(carried_arrays(jp), "cpu", torch.float64))
    tp._augmented_run()
    jg, tg = jp._last_gmg, tp._last_gmg
    assert len(jg.levels) == len(tg.levels) == 4
    b = np.random.default_rng(5).standard_normal((33, 33))
    assert rel(tg.apply(torch.as_tensor(b)), jg.apply(jnp.asarray(b))) <= 1e-12
    np.testing.assert_allclose(tg.coarse_inv.numpy(),
                               np.asarray(jg.coarse_inv), rtol=1e-10,
                               atol=1e-12 * np.abs(jg.coarse_inv).max())
