"""The modules the Stokes slice added to the PyTorch port, each against its
JAX function in float64 on the CPU: the element-form and vector load
vectors, the vector immersed load vector, the Stokes local matrices, the FE
embedding prolongations, CG's weighted stopping norm, the Stokes and
diagonal AL preconditioners, the coupling's column blocks and the vector
coupling, and one V-cycle of the flat vector GMG."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.core.grid import (
    GridSpace, UniformGrid)
from fictitious_domain_al_preconditioners_tpu.core.immersed import (
    parametrized_curve)
from fictitious_domain_al_preconditioners_tpu.models import stokes as jstokes
from fictitious_domain_al_preconditioners_tpu.ops import assembly as JA
from fictitious_domain_al_preconditioners_tpu.ops.coupling import \
    build_coupling as j_build_coupling
from fictitious_domain_al_preconditioners_tpu.ops.krylov import cg as j_cg
from fictitious_domain_al_preconditioners_tpu.ops.blocks import \
    BlockLayout as JLayout
from fictitious_domain_al_preconditioners_tpu.precond import al as JAL
from fictitious_domain_al_preconditioners_tpu.precond import gmg as JG
from fictitious_domain_al_preconditioners_torch.core import grid as tgrid
from fictitious_domain_al_preconditioners_torch.models import stokes as tstokes
from fictitious_domain_al_preconditioners_torch.ops import assembly as TA
from fictitious_domain_al_preconditioners_torch.ops.blocks import \
    BlockLayout as TLayout
from fictitious_domain_al_preconditioners_torch.ops.coupling import \
    build_coupling as t_build_coupling
from fictitious_domain_al_preconditioners_torch.ops.krylov import cg as t_cg
from fictitious_domain_al_preconditioners_torch.precond import al as TAL
from fictitious_domain_al_preconditioners_torch.precond import gmg as TG
from test_torch_stokes import (DIAG_W, carried_arrays, make_config,
                               port_problem)

torch.set_num_threads(1)


def close(a, b, rel=1e-12):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-300)


def spaces(dim, kind, ref=2):
    """The same space in both packages' copies of ``core.grid``."""
    out = []
    for mod in (None, tgrid):
        G = UniformGrid if mod is None else mod.UniformGrid
        S = GridSpace if mod is None else mod.GridSpace
        g = G.hyper_cube(dim, 0.0, 1.0, ref)
        out.append({"q1": lambda: S.q(g, 1), "q2": lambda: S.q(g, 2),
                    "dgp": lambda: S.dgp(g, 1)}[kind]())
    return out


def scalar_fn(p):
    p = np.asarray(p) if not isinstance(p, jnp.ndarray) else p
    return 1.0 + p[:, 0] * p[:, 1] - 0.5 * p[:, 0] ** 2


def vector_fn(p):
    xp = jnp if isinstance(p, jnp.ndarray) else np
    return xp.stack([xp.sin(3.0 * p[:, 0]) + p[:, 1],
                     p[:, 0] * p[:, 1] - 1.0], axis=-1)


@pytest.mark.parametrize("dim,kind,vec", [(2, "q2", False), (2, "q2", True),
                                          (3, "q2", True), (2, "q1", True)])
def test_rhs_vector_matches_reference(dim, kind, vec):
    js, ts = spaces(dim, kind)
    fn = vector_fn if vec else scalar_fn
    order = js.fe.degree + 2
    close(TA.rhs_vector(ts, fn, order=order, device="cpu"),
          JA.rhs_vector(js, fn, order=order))


def test_imm_rhs_vector_matches_reference():
    curve = parametrized_curve(
        lambda t: np.stack([0.45 + 0.21 * np.cos(2 * np.pi * t[:, 0]),
                            0.45 + 0.21 * np.sin(2 * np.pi * t[:, 0])], -1),
        4)
    sp = curve.space(1)
    got = TA.imm_rhs(sp, vector_fn, order=4, device="cpu")
    assert tuple(got.shape) == (sp.n_dofs, 2)
    close(got, JA.imm_rhs(sp, vector_fn, order=4))
    close(TA.imm_rhs(sp, scalar_fn, order=4, device="cpu"),
          JA.imm_rhs(sp, scalar_fn, order=4))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("gd", [10.0, None])
def test_stokes_local_matrices_match_reference(dim, gd):
    js, ts = spaces(dim, "q2")
    h = js.grid.h
    close(TA.velocity_block_local(ts.fe, h, 4, gd),
          JA.velocity_block_local(js.fe, h, 4, gd), rel=0)
    for kind in ("q1", "dgp"):
        jp, tp = spaces(dim, kind)
        close(TA.divergence_block_local(tp.fe, ts.fe, h, 4),
              JA.divergence_block_local(jp.fe, js.fe, h, 4), rel=0)
    np.testing.assert_array_equal(TA.vector_cell_dofs(ts, dim),
                                  JA.vector_cell_dofs(js, dim))


@pytest.mark.parametrize("kind,dim", [("q2", 2), ("q2", 3), ("dgp", 2)])
def test_prolongations_match_reference(kind, dim):
    (jf, tf), (jc, tc) = spaces(dim, kind, 3), spaces(dim, kind, 2)
    jP = JG.make_prolongation(jf, jc)
    tP = TG.make_prolongation(tf, tc, device="cpu")
    rng = np.random.default_rng(0)
    xc, xf = rng.standard_normal(jc.n_dofs), rng.standard_normal(jf.n_dofs)
    close(tP.mv(torch.as_tensor(xc)), jP.mv(jnp.asarray(xc)))
    close(tP.rmv(torch.as_tensor(xf)), jP.rmv(jnp.asarray(xf)))
    jV, tV = JG.VectorProlongation(jP, dim), TG.VectorProlongation(tP, dim)
    assert tV.shape == jV.shape
    xc, xf = rng.standard_normal(jV.shape[1]), rng.standard_normal(
        jV.shape[0])
    close(tV.mv(torch.as_tensor(xc)), jV.mv(jnp.asarray(xc)))
    close(tV.rmv(torch.as_tensor(xf)), jV.rmv(jnp.asarray(xf)))


def test_cg_norm_weight_matches_reference():
    """The weighted norm only moves the stopping test: the same count and
    iterate as the reference, and a count other than the unweighted one."""
    rng = np.random.default_rng(1)
    n = 60
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    w = np.exp(rng.uniform(-3, 3, n))
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    xj, ij = j_cg(lambda v: Aj @ v, jnp.asarray(b), tol=1e-6, max_steps=200,
                  norm_weight=jnp.asarray(w))
    xt, it = t_cg(lambda v: At @ v, torch.as_tensor(b), tol=1e-6,
                  max_steps=200, norm_weight=torch.as_tensor(w))
    assert it.iterations == int(ij.iterations)
    assert it.res0 == pytest.approx(float(ij.res0), rel=1e-12)
    close(xt, xj, rel=1e-10)
    _, plain = t_cg(lambda v: At @ v, torch.as_tensor(b), tol=1e-6,
                    max_steps=200)
    assert plain.iterations != it.iterations


@pytest.mark.parametrize("which", ["stokes", "diagonal"])
def test_al_preconditioners_match_reference(which):
    sizes = (7, 4, 5)
    rng = np.random.default_rng(2)
    mats = [rng.standard_normal((a, b)) for a, b in
            ((7, 7), (7, 4), (7, 5), (5, 5), (4, 4))]
    u = rng.standard_normal(sum(sizes))

    def ops(asarr):
        Ai, Bt, Ct, W, Mp = (asarr(m) for m in mats)
        return ((lambda v: Ai @ v), (lambda v: Bt @ v), (lambda v: Ct @ v),
                (lambda v: W @ v), (lambda v: Mp @ v))

    (ja, jb, jc, jw, jm), (ta, tb, tc, tw, tm) = ops(jnp.asarray), ops(
        torch.as_tensor)
    if which == "stokes":
        jP = JAL.al_preconditioner_stokes(JLayout(sizes), ja, jb, jc, jw, jm,
                                          10.0, 3.0)
        tP = TAL.al_preconditioner_stokes(TLayout(sizes), ta, tb, tc, tw, tm,
                                          10.0, 3.0)
    else:
        jP = JAL.al_preconditioner_diagonal(JLayout(sizes), ja, jw, jm, 10.0,
                                            3.0)
        tP = TAL.al_preconditioner_diagonal(TLayout(sizes), ta, tw, tm, 10.0,
                                            3.0)
    close(tP(torch.as_tensor(u)), jP(jnp.asarray(u)))


@pytest.fixture(scope="module")
def couplings():
    js, ts = spaces(2, "q2", 4)
    curve = parametrized_curve(
        lambda t: np.stack([0.45 + 0.21 * np.cos(2 * np.pi * t[:, 0]),
                            0.45 + 0.21 * np.sin(2 * np.pi * t[:, 0])], -1),
        5)
    imm = curve.space(1)
    return (j_build_coupling(js, imm, 4),
            t_build_coupling(ts, imm, 4, device="cpu"))


def test_coupling_column_blocks_match_reference(couplings):
    jC, tC = couplings
    rng = np.random.default_rng(4)
    u = rng.standard_normal((jC.shape[1], 3))
    lam = rng.standard_normal((jC.shape[0], 3))
    close(tC.mv(torch.as_tensor(u)), jC.mv(jnp.asarray(u)))
    close(tC.rmv(torch.as_tensor(lam)), jC.rmv(jnp.asarray(lam)))
    close(tC.interp_bg(torch.as_tensor(u)), jC.interp_bg(jnp.asarray(u)))
    close(tC.interp_bg(torch.as_tensor(u[:, 0])),
          jC.interp_bg(jnp.asarray(u[:, 0])))
    # the scalar applies are the columns of the block ones
    close(tC.mv(torch.as_tensor(u[:, 1])), tC.mv(torch.as_tensor(u))[:, 1],
          rel=1e-15)


def test_vector_coupling_matches_reference(couplings):
    jC, tC = couplings
    jV, tV = jstokes.VectorCoupling(jC, 2), tstokes.VectorCoupling(tC, 2)
    assert tV.shape == jV.shape
    rng = np.random.default_rng(5)
    u, lam = rng.standard_normal(jV.shape[1]), rng.standard_normal(
        jV.shape[0])
    close(tV.mv(torch.as_tensor(u)), jV.mv(jnp.asarray(u)))
    close(tV.rmv(torch.as_tensor(lam)), jV.rmv(jnp.asarray(lam)))
    w = rng.uniform(1.0, 2.0, jC.shape[0])
    close(tV.al_term_diag(w, 10.0), jV.al_term_diag(w, 10.0))


def test_flat_vector_vcycle_matches_reference():
    """One V-cycle of the velocity hierarchy at 4:5 (n_comp = 2, the
    element-form fine level and two band levels with the AL term) equals
    the JAX package's ``build_gmg(n_comp=2)`` on the same Lanczos vectors
    (``lanczos_start(i, n)`` with ``n = 2·n_level``), and so does its
    coarse inverse."""
    def cfg_kw(mod):
        return make_config(mod, al=DIAG_W)

    jp = jstokes.StokesProblem(cfg_kw(jstokes))
    jp.setup()
    tp = port_problem(jp, cfg_kw)
    _, w = jp._inv_w()
    jg = jp._gmg_velocity(True, 10.0, w)
    _, wt = tp._inv_w()
    close(wt, w)
    tg = tp._gmg_velocity(True, 10.0, wt)
    assert tp.results["gmg_routes"] == ["element", "band", "band"]
    assert len(tg.levels) == len(jg.levels) == 3
    starts = carried_arrays(jp)["lanczos_starts"]
    assert [len(s) for s in starts] == [2 * lv.space.n_dofs
                                        for lv in tg.levels]
    rng = np.random.default_rng(6)
    b = rng.standard_normal(tp.layout.sizes[0]) * tp.free.numpy()
    xj = jax.jit(jg.apply)(jnp.asarray(b))
    close(tg.apply(torch.as_tensor(b)), xj, rel=1e-10)
    np.testing.assert_allclose(
        np.asarray(tg.coarse_inv),
        np.asarray(jg.coarse_inv), rtol=0,
        atol=1e-9 * np.abs(np.asarray(jg.coarse_inv)).max())
