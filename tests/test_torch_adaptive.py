"""Local refinement near Γ in the PyTorch port against the JAX package, in
float64 on the CPU: the tree, the folded space and its dof tables exactly;
the element-form matrices (whose cells without a hanging node keep their
level's shared local matrix) against the JAX package's dense fold, the load
vector, the L2 error, the coupling table and the prolongation to 1e-12; CG
on the tree's GMG with the JAX package's iteration count.  Fixtures: the
refined quadtree of ``tests/test_adaptive.py:18-24`` and the octree of its
``TestOctree3D``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.core import adaptive as jad
from fictitious_domain_al_preconditioners_tpu.core.immersed import \
    parametrized_curve as j_curve
from fictitious_domain_al_preconditioners_tpu.ops import assembly as jas
from fictitious_domain_al_preconditioners_tpu.ops.coupling import \
    build_coupling as j_coupling
from fictitious_domain_al_preconditioners_tpu.precond import gmg as jgmg
from fictitious_domain_al_preconditioners_torch.core import adaptive as tad
from fictitious_domain_al_preconditioners_torch.core.immersed import \
    parametrized_curve as t_curve
from fictitious_domain_al_preconditioners_torch.ops import assembly as tas
from fictitious_domain_al_preconditioners_torch.ops.coupling import \
    build_coupling as t_coupling
from fictitious_domain_al_preconditioners_torch.ops.operators import \
    CellMatrixSum
from fictitious_domain_al_preconditioners_torch.precond import gmg as tgmg

torch.set_num_threads(1)

TOL = 1e-12     # relative to the reference's max


def circle_points(n=200, r=0.3, c=(0.4, 0.4)):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], -1)


def sphere_points():
    theta = np.linspace(0, np.pi, 20)
    phi = np.linspace(0, 2 * np.pi, 40)
    TH, PH = np.meshgrid(theta, phi)
    return np.stack([0.5 + 0.25 * np.sin(TH) * np.cos(PH),
                     0.5 + 0.25 * np.sin(TH) * np.sin(PH),
                     0.5 + 0.25 * np.cos(TH)], axis=-1).reshape(-1, 3)


def grids(mod, dim):
    """The 2D fixture (base 3, three steps near a circle) or the 3D one
    (base 2, one step near a sphere) in ``mod``'s package."""
    if dim == 2:
        g = mod.AdaptiveGrid.uniform(2, 3)
        for _ in range(3):
            g = g.refine_near(circle_points())
        return g
    return mod.AdaptiveGrid.uniform(3, 2).refine_near(sphere_points())


CASES = [(2, 1), (2, 2), (3, 1), (3, 2)]
_SPACES = {}


def spaces(dim, degree):
    key = (dim, degree)
    if key not in _SPACES:
        _SPACES[key] = (jad.AdaptiveSpace(grids(jad, dim), degree),
                        tad.AdaptiveSpace(grids(tad, dim), degree))
    return _SPACES[key]


def close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("dim,degree", CASES)
def test_space_matches_reference_exactly(dim, degree):
    js, ts = spaces(dim, degree)
    assert (js.grid.levels == ts.grid.levels).all()
    assert (js.grid.ij == ts.grid.ij).all()
    assert ts.n_dofs == js.n_dofs
    assert ts.n_constrained_cells == js.n_constrained_cells > 0
    np.testing.assert_array_equal(ts._node_pos, js._node_pos)
    np.testing.assert_array_equal(ts.cell_dofs, js.cell_dofs)
    np.testing.assert_array_equal(ts.fold_w, js.fold_w)
    np.testing.assert_array_equal(ts.dof_points, js.dof_points)
    for ids in (None, [0, 2]):
        np.testing.assert_array_equal(ts.boundary_dof_mask(ids),
                                      js.boundary_dof_mask(ids))
    q = np.random.default_rng(1).uniform(0.01, 0.99, (300, dim))
    for a, b in zip(ts.tabulate_at(q), js.tabulate_at(q)):
        np.testing.assert_array_equal(a, b)
    u = np.random.default_rng(2).standard_normal(ts.n_dofs)
    np.testing.assert_array_equal(ts.expand(u), js.expand(u))
    assert ts.can_coarsen() == js.can_coarsen()
    np.testing.assert_array_equal(ts.coarse_space().cell_dofs,
                                  js.coarse_space().cell_dofs)


def test_dgp_space_matches_reference():
    jg, tg = grids(jad, 2), grids(tad, 2)
    js, ts = jad.AdaptiveDGPSpace(jg), tad.AdaptiveDGPSpace(tg)
    assert ts.n_dofs == js.n_dofs
    np.testing.assert_array_equal(ts.cell_dofs, js.cell_dofs)
    np.testing.assert_array_equal(ts.fold_w, js.fold_w)
    np.testing.assert_array_equal(ts.dof_points, js.dof_points)
    q = np.random.default_rng(1).uniform(0.01, 0.99, (100, 2))
    for a, b in zip(ts.tabulate_at(q), js.tabulate_at(q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim,degree", CASES)
def test_mass_and_laplace_match_dense_fold(dim, degree):
    """The split storage (a level's shared local on its plain cells, folded
    locals on the constrained ones) applies as the JAX package's dense fold,
    forward and transposed, with the same diagonal."""
    js, ts = spaces(dim, degree)
    x = np.random.default_rng(3).standard_normal(ts.n_dofs)
    for jfn, tfn in ((jas.mass_matrix, tas.mass_matrix),
                     (jas.laplace_matrix, tas.laplace_matrix)):
        J = jfn(js)
        T = tfn(ts, device="cpu")
        assert isinstance(T, CellMatrixSum)
        assert sum(p.shared_local for p in T.parts) == len(T.parts) - 1
        close(T.mv(torch.as_tensor(x)).numpy(), J.mv(jnp.asarray(x)))
        close(T.rmv(torch.as_tensor(x)).numpy(), J.rmv(jnp.asarray(x)))
        close(T.diag_host(), J.diag())
    if dim == 2 and degree == 1:
        close(tas.laplace_matrix(ts, device="cpu").to_dense(),
              jas.laplace_matrix(js).to_dense())


@pytest.mark.parametrize("dim", [2, 3])
def test_vector_and_mixed_blocks_match(dim):
    """The Stokes blocks on a tree: the Q2 vector velocity block and the
    divergence against a Q1 pressure (and, in 2D, the P1disc one)."""
    js, ts = spaces(dim, 2)
    jp, tp = spaces(dim, 1)
    order = 4
    fe = ts.fe

    def vel(h):
        return tas.velocity_block_local(fe, h, order, 10.0)

    rng = np.random.default_rng(4)
    xu = rng.standard_normal(dim * ts.n_dofs)
    A_j = jas.adaptive_vector_cell_matrix(js, vel, dim)
    A_t = tas.adaptive_vector_cell_matrix(ts, vel, dim, device="cpu")
    close(A_t.mv(torch.as_tensor(xu)).numpy(), A_j.mv(jnp.asarray(xu)))
    close(A_t.diag_host(), A_j.diag())
    pairs = [(jp, tp)]
    if dim == 2:
        pairs.append((jad.AdaptiveDGPSpace(js.grid),
                      tad.AdaptiveDGPSpace(ts.grid)))
    for jps, tps in pairs:
        def div(h):
            return tas.divergence_block_local(tps.fe, fe, h, order)

        B_j = jas.adaptive_mixed_cell_matrix(jps, js, div, dim)
        B_t = tas.adaptive_mixed_cell_matrix(tps, ts, div, dim, device="cpu")
        xp = rng.standard_normal(tps.n_dofs)
        close(B_t.mv(torch.as_tensor(xu)).numpy(), B_j.mv(jnp.asarray(xu)))
        close(B_t.rmv(torch.as_tensor(xp)).numpy(), B_j.rmv(jnp.asarray(xp)))
        close(tas.mass_matrix(tps, device="cpu").row_sums().numpy(),
              jas.mass_matrix(jps).row_sums())


@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (3, 2)])
def test_load_vector_and_errors_match(dim, degree):
    js, ts = spaces(dim, degree)

    def f(p):
        return np.sin(np.pi * p[:, 0]) * np.cos(p[:, 1]) + p[:, -1] ** 2

    def grad(p):
        return np.stack([np.pi * np.cos(np.pi * p[:, 0]) * np.cos(p[:, 1]),
                         -np.sin(np.pi * p[:, 0]) * np.sin(p[:, 1])]
                        + [np.zeros(len(p))] * (dim - 2), -1) + \
            np.eye(dim)[-1] * 2 * p[:, -1:]

    close(tas.rhs_vector(ts, f, device="cpu").numpy(), jas.rhs_vector(js, f))

    def fv(p):
        return np.stack([f(p), p[:, 0] * p[:, 1]], -1)

    close(tas.rhs_vector(ts, fv, device="cpu").numpy(),
          jas.rhs_vector(js, fv))
    u = f(ts.dof_points)
    assert tas.l2_error(ts, u, f) == pytest.approx(jas.l2_error(js, u, f),
                                                   rel=TOL)
    assert tas.h1_error(ts, u, grad) == pytest.approx(
        jas.h1_error(js, u, grad), rel=TOL)


def test_coupling_table_matches():
    """The coupling table of a curve on the quadtree (folded tabulation):
    equal dof tables, values to 1e-12, C and Cᵀ applies, and sum(C) =
    |Γ|."""
    js, ts = spaces(2, 1)

    def conf(p):
        return np.stack([0.4 + 0.3 * np.cos(2 * np.pi * p[:, 0]),
                         0.4 + 0.3 * np.sin(2 * np.pi * p[:, 0])], -1)

    jc, tc = j_curve(conf, 5), t_curve(conf, 5)
    Cj = j_coupling(js, jc.space(1), order=3)
    Ct = t_coupling(ts, tc.space(1), order=3, device="cpu")
    np.testing.assert_array_equal(Ct.host["bg_dofs"], np.asarray(Cj.bg_dofs))
    close(Ct.host["bg_phi"], Cj.bg_phi)
    x = np.random.default_rng(5).standard_normal(ts.n_dofs)
    lam = np.random.default_rng(6).standard_normal(Ct.shape[0])
    close(Ct.mv(torch.as_tensor(x)).numpy(), Cj.mv(jnp.asarray(x)))
    close(Ct.rmv(torch.as_tensor(lam)).numpy(), Cj.rmv(jnp.asarray(lam)))
    assert Ct.sum() == pytest.approx(tc.measure, abs=1e-10)


@pytest.mark.parametrize("dim", [2, 3])
def test_prolongation_matches(dim):
    js, ts = spaces(dim, 2 if dim == 3 else 1)
    Pj = jgmg.make_prolongation(js, js.coarse_space())
    Pt = tgmg.make_prolongation(ts, ts.coarse_space(), device="cpu")
    assert Pt.shape == Pj.shape
    rng = np.random.default_rng(7)
    xc, xf = rng.standard_normal(Pt.shape[1]), rng.standard_normal(Pt.shape[0])
    close(Pt.mv(torch.as_tensor(xc)).numpy(), Pj.mv(jnp.asarray(xc)))
    close(Pt.rmv(torch.as_tensor(xf)).numpy(), Pj.rmv(jnp.asarray(xf)))


def test_cg_on_tree_gmg_matches_reference():
    """``tests/test_adaptive.py::test_poisson_adaptive_gmg_converges`` in
    both packages: CG on the constrained stiffness, preconditioned by the
    GMG that truncates the quadtree; equal iteration counts and solutions,
    with the JAX package's Lanczos start vectors."""
    from fictitious_domain_al_preconditioners_tpu.ops.krylov import cg as jcg
    from fictitious_domain_al_preconditioners_tpu.ops.operators import \
        constrain as jconstrain
    from fictitious_domain_al_preconditioners_torch.ops.krylov import \
        cg as tcg
    from fictitious_domain_al_preconditioners_torch.ops.operators import \
        constrain as tconstrain

    js, ts = spaces(2, 1)
    K = jas.laplace_matrix(js)
    free = jnp.asarray(~js.boundary_dof_mask())

    def jfactory(s):
        Ks = K if s is js else jas.laplace_matrix(s)
        return Ks.mv, Ks.diag()

    gmg = jgmg.build_gmg(js, jfactory, free_mask=free)
    b = jnp.where(free, jas.rhs_vector(js, lambda p: np.ones(len(p))), 0.0)
    xj, ij = jcg(jconstrain(K.as_linop(), free), b, M=gmg.apply, tol=1e-10,
                 max_steps=60)

    Kt = tas.laplace_matrix(ts, device="cpu")
    free_t = torch.as_tensor(np.asarray(free))

    def tfactory(s):
        Ks = Kt if s is ts else tas.laplace_matrix(s, device="cpu")
        return Ks.mv, Ks.diag_host()

    tg = tgmg.build_gmg_flat(
        ts, tfactory, free_mask=free_t,
        lanczos_start=lambda i, n: np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (n,), dtype=jnp.float64)))
    assert len(tg.levels) == len(gmg.levels) == 5
    bt = torch.as_tensor(np.asarray(b))
    xt, it = tcg(tconstrain(Kt.as_linop(), free_t), bt, M=tg.apply,
                 tol=1e-10, max_steps=60)
    assert bool(ij.converged) and it.converged
    assert it.iterations == int(ij.iterations)
    close(xt.numpy(), xj, tol=1e-9)
