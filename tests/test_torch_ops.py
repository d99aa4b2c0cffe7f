"""Operator applies of the PyTorch port against the JAX package in float64:
lattice stiffness and transfers, C/Cᵀ, the Γ-band AL applies, constraints."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fictitious_domain_al_preconditioners_tpu.core as jcore
import fictitious_domain_al_preconditioners_torch.core as tcore
from fictitious_domain_al_preconditioners_tpu.ops import operators as jops
from fictitious_domain_al_preconditioners_tpu.ops.blocks import (
    BlockLayout as JLayout, block_operator as j_block_operator)
from fictitious_domain_al_preconditioners_tpu.ops.coupling import \
    build_coupling as j_build_coupling
from fictitious_domain_al_preconditioners_tpu.ops.linop import LinOp as JLinOp
from fictitious_domain_al_preconditioners_tpu.parallel import lattice as jlat
from fictitious_domain_al_preconditioners_torch.ops import operators as tops
from fictitious_domain_al_preconditioners_torch.ops.blocks import (
    BlockLayout as TLayout, block_operator as t_block_operator)
from fictitious_domain_al_preconditioners_torch.ops.coupling import \
    build_coupling as t_build_coupling
from fictitious_domain_al_preconditioners_torch.ops.linop import \
    LinOp as TLinOp
from fictitious_domain_al_preconditioners_torch.parallel import lattice as tlat
from fictitious_domain_al_preconditioners_torch.utils import ParsedFunction

torch.set_num_threads(1)

CONF = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")
RTOL = 1e-12


def close(t, j, rtol=RTOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = max(float(np.abs(j).max()), 1e-300)
    assert float(np.abs(t - j).max()) <= rtol * scale


def _setup(ref):
    f = ParsedFunction(*CONF)
    out = {}
    for name, mod in (("j", jcore), ("t", tcore)):
        curve = mod.parametrized_curve(lambda p: np.asarray(f(p)), ref)
        space = mod.GridSpace.q(mod.UniformGrid.hyper_cube(2, 0.0, 1.0, ref),
                                1)
        out[name] = (curve, space)
    return out


@pytest.mark.parametrize("ref", [3, 5])
def test_lattice_laplace_and_transfers(ref):
    s = _setup(ref)
    js, ts = s["j"][1], s["t"][1]
    jl, tl = jlat.LatticeOps.for_space(js), tlat.LatticeOps.for_space(ts)
    u = np.random.default_rng(ref).standard_normal(tl.shape)
    close(tl.laplace(torch.as_tensor(u)), jl.laplace(jnp.asarray(u)))
    close(tl.laplace_diag(), jl.laplace_diag(), rtol=1e-15)
    uc = np.random.default_rng(ref + 1).standard_normal(
        tuple(reversed(js.coarse_space().n_points_1d)))
    close(tlat.lattice_prolong(torch.as_tensor(uc)),
          jlat.lattice_prolong(jnp.asarray(uc)), rtol=1e-15)
    close(tlat.lattice_restrict(torch.as_tensor(u)),
          jlat.lattice_restrict(jnp.asarray(u)), rtol=1e-15)
    flat = np.arange(ts.n_dofs, dtype=float)
    np.testing.assert_array_equal(
        tlat.flat_to_lattice(torch.as_tensor(flat), ts.n_points_1d).numpy(),
        np.asarray(jlat.flat_to_lattice(jnp.asarray(flat), js.n_points_1d)))


@pytest.mark.parametrize("ref", [4, 5])
def test_coupling_applies(ref):
    s = _setup(ref)
    (jc, js), (tc, ts) = s["j"], s["t"]
    jC = j_build_coupling(js, jc.space(1), 3)
    tC = t_build_coupling(ts, tc.space(1), 3, device="cpu")
    rng = np.random.default_rng(ref)
    u = rng.standard_normal(ts.n_dofs)
    lam = rng.standard_normal(tC.shape[0])
    close(tC.mv(torch.as_tensor(u)), jC.mv(jnp.asarray(u)))
    close(tC.rmv(torch.as_tensor(lam)), jC.rmv(jnp.asarray(lam)))
    gamma = 10.0 / tc.h_max
    free = ~ts.boundary_dof_mask([0, 1, 2, 3])
    lat = tuple(reversed(ts.n_points_1d))
    u2 = u.reshape(lat)
    jp = jC.patch_al_lattice(js, gamma, free=free)
    tp = tC.patch_al_lattice(ts, gamma, free=free)
    close(tp[0](torch.as_tensor(u2)), jp[0](jnp.asarray(u2)))
    close(tp[1], jp[1], rtol=1e-15)
    # the coarsest flagship level, where the band touches the boundary
    jsc, tsc = js, ts
    while jsc.grid.ncells[0] > 4:
        jsc, tsc = jsc.coarse_space(), tsc.coarse_space()
    jCc = j_build_coupling(jsc, jc.space(1), 3)
    tCc = t_build_coupling(tsc, tc.space(1), 3, device="cpu")
    assert tCc.patch_al_lattice(tsc, gamma) is None
    jal, jdiag = jCc.compact_al(gamma)
    tal, tdiag = tCc.compact_al(gamma)
    uc = rng.standard_normal(tsc.n_dofs)
    close(tal(torch.as_tensor(uc)), jal(jnp.asarray(uc)))
    close(tdiag, jdiag)


def test_constraints_and_blocks():
    rng = np.random.default_rng(3)
    n = 40
    A = rng.standard_normal((n, n))
    free = rng.uniform(size=n) > 0.3
    rhs, bc = rng.standard_normal(n), rng.standard_normal(n)
    x = rng.standard_normal(n)
    tA = torch.as_tensor(A)
    jA = jnp.asarray(A)
    top = tops.constrain(lambda v: tA @ v, torch.as_tensor(free))
    jop = jops.constrain(JLinOp(lambda v: jA @ v, (n, n)), jnp.asarray(free))
    close(top(torch.as_tensor(x)), jop(jnp.asarray(x)))
    close(tops.dirichlet_rhs(lambda v: tA @ v, torch.as_tensor(rhs),
                             torch.as_tensor(free), torch.as_tensor(bc)),
          jops.dirichlet_rhs(JLinOp(lambda v: jA @ v, (n, n)),
                             jnp.asarray(rhs), jnp.asarray(free),
                             jnp.asarray(bc)))
    B = rng.standard_normal((7, n))
    tB, jB = torch.as_tensor(B), jnp.asarray(B)
    tl, jl = TLayout((n, 7)), JLayout((n, 7))
    tbo = t_block_operator(tl, tl, [
        [TLinOp(lambda v: tA @ v, (n, n)), TLinOp(lambda v: tB.T @ v, (n, 7))],
        [TLinOp(lambda v: tB @ v, (7, n)), None]])
    jbo = j_block_operator(jl, jl, [
        [JLinOp(lambda v: jA @ v, (n, n)), JLinOp(lambda v: jB.T @ v, (n, 7))],
        [JLinOp(lambda v: jB @ v, (7, n)), None]])
    y = rng.standard_normal(n + 7)
    close(tbo(torch.as_tensor(y)), jbo(jnp.asarray(y)))
