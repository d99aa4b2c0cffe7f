"""Module parity of the port's AL machinery against the JAX package, in
float64 on the CPU: the lattice mass inverse (both forms) and the other W⁻¹
operators, diag(M²), the SpGEMM Cᵀdiag(w)C, the band stencil (against the
JAX apply and the dense COO matvec), the coupling's AL terms and diagonals,
the lattice mass, the background matrices, the LinOp algebra, CG's Lanczos
coefficients and condition estimate, the two elliptic AL preconditioners,
the H1 error and the grid generators.  The same inputs, made from a seed
with numpy, go through both functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.core import generators as JG
from fictitious_domain_al_preconditioners_tpu.core.grid import \
    GridSpace as JGridSpace
from fictitious_domain_al_preconditioners_tpu.ops import assembly as JA
from fictitious_domain_al_preconditioners_tpu.ops import krylov as JK
from fictitious_domain_al_preconditioners_tpu.ops import linop as JL
from fictitious_domain_al_preconditioners_tpu.ops import sparse as JS
from fictitious_domain_al_preconditioners_tpu.ops.blocks import \
    BlockLayout as JLayout
from fictitious_domain_al_preconditioners_tpu.ops.coupling import \
    build_coupling as j_build_coupling
from fictitious_domain_al_preconditioners_tpu.ops.sparse_band import \
    lattice_band_linop as j_band
from fictitious_domain_al_preconditioners_tpu.parallel.lattice import \
    LatticeOps as JLattice
from fictitious_domain_al_preconditioners_tpu.precond import al as JAL
from fictitious_domain_al_preconditioners_tpu.precond import weights as JW
from fictitious_domain_al_preconditioners_torch.core import generators as TG
from fictitious_domain_al_preconditioners_torch.core.grid import GridSpace
from fictitious_domain_al_preconditioners_torch.core.immersed import \
    ImmersedSpace
from fictitious_domain_al_preconditioners_torch.ops import assembly as TA
from fictitious_domain_al_preconditioners_torch.ops import krylov as TK
from fictitious_domain_al_preconditioners_torch.ops import linop as TL
from fictitious_domain_al_preconditioners_torch.ops import sparse as TS
from fictitious_domain_al_preconditioners_torch.ops.blocks import \
    BlockLayout as TLayout
from fictitious_domain_al_preconditioners_torch.ops.coupling import \
    build_coupling as t_build_coupling
from fictitious_domain_al_preconditioners_torch.ops.sparse_band import \
    lattice_band_linop as t_band
from fictitious_domain_al_preconditioners_torch.parallel.lattice import \
    LatticeOps as TLattice
from fictitious_domain_al_preconditioners_torch.precond import al as TAL
from fictitious_domain_al_preconditioners_torch.precond import weights as TW

torch.set_num_threads(1)

CPU = dict(device="cpu", dtype=torch.float64)


def rel_err(got, ref):
    """max |got - ref| / max |ref| of a tensor or array against an array."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def setting():
    """The default elliptic configuration's spaces at cycle 0 in both
    packages: background 17², the immersed box's lattice twin 5², their
    couplings and immersed mass matrices."""
    grid = TG.background_grid_from_name("hyper_cube", "-1: 1: true", 2, 4)
    jgrid = JG.background_grid_from_name("hyper_cube", "-1: 1: true", 2, 4)
    args = "-0.14: 0.44: true"
    fg_grid = TG.background_grid_from_name("hyper_cube", args, 2, 2)
    mesh = TG.immersed_mesh_from_name("hyper_cube", args, 2, 2)
    jmesh = JG.immersed_mesh_from_name("hyper_cube", args, 2, 2)
    space, jspace = GridSpace.q(grid, 1), JGridSpace.q(jgrid, 1)
    fg = GridSpace.q(fg_grid, 1)
    fg_space = ImmersedSpace(mesh, fg.fe, fg.cell_dofs, fg.n_dofs)
    from fictitious_domain_al_preconditioners_tpu.core.immersed import \
        ImmersedSpace as JImmersedSpace
    jfg = JGridSpace.q(JG.background_grid_from_name("hyper_cube", args, 2, 2),
                       1)
    jfg_space = JImmersedSpace(jmesh, jfg.fe, jfg.cell_dofs, jfg.n_dofs)
    return dict(
        space=space, jspace=jspace, fg=fg, jfg=jfg,
        C=t_build_coupling(space, fg_space, order=2, **CPU),
        jC=j_build_coupling(jspace, jfg_space, order=2),
        M=TA.imm_mass_matrix(fg_space, order=2, **CPU),
        jM=JA.imm_mass_matrix(jfg_space, order=2))


def test_generators_match_reference():
    for name, args in (("hyper_cube", "-1: 1: true"),
                       ("hyper_rectangle", "0,0: 2,1: false")):
        g = TG.background_grid_from_name(name, args, 2, 3)
        jg = JG.background_grid_from_name(name, args, 2, 3)
        assert np.allclose(g.h, jg.h) and tuple(g.ncells) == tuple(jg.ncells)
        assert np.allclose(g.origin, jg.origin)
    for name, args in (("hyper_cube", "-0.14: 0.44: true"),
                       ("hyper_ball", "0,0 : 1.")):
        m = TG.immersed_mesh_from_name(name, args, 2, 2)
        jm = JG.immersed_mesh_from_name(name, args, 2, 2)
        assert m.n_cells == jm.n_cells and m.h_max == pytest.approx(jm.h_max)
        assert m.measure == pytest.approx(jm.measure)
    with pytest.raises(ValueError):
        TG.background_grid_from_name("hyper_ball", "", 2, 1)


@pytest.mark.parametrize("squared", [False, True])
def test_lattice_mass_inverse_matches_reference(setting, squared):
    """Both forms against the JAX function and the dense inverse, on flat
    vectors, (n, k) stacks and lattice tensors, with a scale."""
    fg, jfg = setting["fg"], setting["jfg"]
    inv = TW.lattice_mass_inverse(fg, squared=squared, scale=0.3, **CPU)
    jinv = JW.lattice_mass_inverse(jfg, squared=squared, scale=0.3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(fg.n_dofs)
    X = rng.standard_normal((fg.n_dofs, 3))
    assert rel_err(inv(t(x)), jinv(jnp.asarray(x))) <= 1e-13
    assert rel_err(inv(t(X)), jinv(jnp.asarray(X))) <= 1e-13
    lat = t(x).reshape(tuple(reversed(fg.n_points_1d)))
    assert rel_err(inv(lat).reshape(-1), jinv(jnp.asarray(x))) <= 1e-13
    M = TA.mass_matrix(fg, **CPU).to_dense()
    dense = np.linalg.matrix_power(np.linalg.inv(M), 2 if squared else 1)
    s = 0.09 if squared else 0.3
    assert rel_err(inv(t(x)), s * dense @ x) <= 1e-12
    assert TW.lattice_mass_inverse(None) is None


def test_weight_inverses_match_reference(setting):
    """inv_diag_of_m_squared, inv_diag_squared, and inv_exact /
    inv_squared_exact on the dense and the Jacobi-CG paths."""
    M, jM = setting["M"], setting["jM"]
    x = np.random.default_rng(1).standard_normal(M.shape[0])
    for tfn, jfn in ((TW.inv_diag_of_m_squared, JW.inv_diag_of_m_squared),
                     (TW.inv_diag_squared, JW.inv_diag_squared),
                     (TW.inv_exact, JW.inv_exact),
                     (TW.inv_squared_exact, JW.inv_squared_exact)):
        assert rel_err(tfn(M)(t(x)), jfn(jM)(jnp.asarray(x))) <= 1e-12
    assert np.allclose(TW.diag_of_m_squared(M),
                       np.diag(M.to_dense() @ M.to_dense()))
    # the Jacobi-CG path (above DENSE_INV_MAX) to the reference's reduction
    cap = TW.DENSE_INV_MAX
    try:
        TW.DENSE_INV_MAX = 0
        y = TW.inv_exact(M)(t(x)).numpy()
        y2 = TW.inv_squared_exact(M)(t(x)).numpy()
    finally:
        TW.DENSE_INV_MAX = cap
    dense = np.linalg.inv(M.to_dense())
    assert rel_err(y, dense @ x) <= 1e-12
    assert rel_err(y2, dense @ dense @ x) <= 1e-11


def test_spgemm_ctwc_matches_reference(setting):
    C, jC = setting["C"], setting["jC"]
    w = np.random.default_rng(2).uniform(0.5, 2.0, C.shape[0])
    coo = TS.spgemm_ctwc(TS.COO.from_coupling(C), w)
    jcoo = JS.spgemm_ctwc(JS.COO.from_coupling(jC), w)
    assert np.array_equal(coo.rows, jcoo.rows)
    assert np.array_equal(coo.cols, jcoo.cols)
    assert rel_err(coo.vals, jcoo.vals) <= 1e-14
    dense = C.to_dense()
    assert rel_err(coo.to_dense(), dense.T @ (w[:, None] * dense)) <= 1e-13
    assert TS.coo_transpose(coo).shape == coo.shape


def band_cases(setting):
    """(space, jax space, COO, n_comp): the AL band γ·Cᵀdiag(w)C (interior
    patch), the background mass (its patch is the whole lattice, the padded
    path) and a 2-component block operator."""
    space, jspace = setting["space"], setting["jspace"]
    w = np.random.default_rng(3).uniform(0.5, 2.0, setting["C"].shape[0])
    al = TS.spgemm_ctwc(TS.COO.from_coupling(setting["C"]), w)
    mass = TS.COO.from_cell_matrix(TA.mass_matrix(space, **CPU))
    stiff = TS.COO.from_cell_matrix(TA.laplace_matrix(space, **CPU))
    n = space.n_dofs
    block = TS.COO.from_triplets(
        np.concatenate([mass.rows, stiff.rows, n + mass.rows]),
        np.concatenate([mass.cols, n + stiff.cols, n + mass.cols]),
        np.concatenate([mass.vals, stiff.vals, 2.0 * mass.vals]),
        (2 * n, 2 * n))
    return [("al", al, 1), ("mass", mass, 1), ("block", block, 2)]


@pytest.mark.parametrize("case", ["al", "mass", "block"])
def test_band_stencil_matches_reference_and_dense(setting, case):
    space, jspace = setting["space"], setting["jspace"]
    _, coo, n_comp = next(c for c in band_cases(setting) if c[0] == case)
    band = t_band(space, coo, scale=2.5, n_comp=n_comp, **CPU)
    jband = j_band(jspace, JS.COO(coo.rows, coo.cols, coo.vals, coo.shape),
                   scale=2.5, n_comp=n_comp)
    x = np.random.default_rng(4).standard_normal(coo.shape[0])
    y = band[0](t(x))
    assert rel_err(y, jband[0](jnp.asarray(x))) <= 1e-13
    assert rel_err(y, 2.5 * coo.mv(x)) <= 1e-13
    assert np.allclose(band[2], np.asarray(jband[2]), rtol=1e-14, atol=0)
    assert np.allclose(band[2], 2.5 * coo.diag(), rtol=1e-13, atol=1e-300)
    if n_comp == 1:
        lat = tuple(reversed(space.n_points_1d))
        assert rel_err(band[1](t(x).reshape(lat)).reshape(-1), y) == 0.0
    else:
        assert band[1] is None
    # out of reach: a band wider than max_band, too many planes, no lattice
    assert t_band(space, coo, max_band=0, n_comp=n_comp, **CPU) is None
    assert t_band(space, coo, max_planes=1, n_comp=n_comp, **CPU) is None
    assert t_band(None, coo, **CPU) is None


def test_coupling_al_terms_match_reference(setting):
    C, jC, space = setting["C"], setting["jC"], setting["space"]
    rng = np.random.default_rng(5)
    u = rng.standard_normal(C.shape[1])
    w = rng.uniform(0.5, 2.0, C.shape[0])
    assert rel_err(C.al_term_diag(w, 3.0), jC.al_term_diag(w, 3.0)) <= 1e-14
    dense = C.to_dense()
    assert rel_err(C.al_term_diag(w, 3.0),
                   3.0 * np.diag(dense.T @ (w[:, None] * dense))) <= 1e-13
    inv_w = TL.diag_op(t(w))
    jinv_w = JL.diag_op(jnp.asarray(w))
    assert rel_err(C.al_term(inv_w, 3.0)(t(u)),
                   jC.al_term(jinv_w, 3.0)(jnp.asarray(u))) <= 1e-13
    assert rel_err(C.particle_mass_term(3.0)(t(u)),
                   jC.particle_mass_term(3.0)(jnp.asarray(u))) <= 1e-13
    assert rel_err(C.particle_mass_diag(3.0),
                   jC.particle_mass_diag(3.0)) <= 1e-14
    st, jst = C.patch_stencil_al(space, 3.0), jC.patch_stencil_al(
        setting["jspace"], 3.0)
    assert rel_err(st[0](t(u)), jst[0](jnp.asarray(u))) <= 1e-13
    assert rel_err(st[0](t(u)), C.particle_mass_term(3.0)(t(u))) <= 1e-13
    assert rel_err(st[1], jst[1]) <= 1e-14
    assert C.sum() == pytest.approx(jC.sum(), rel=1e-14)
    assert rel_err(C.to_dense(), jC.to_dense()) <= 1e-14
    assert all(np.array_equal(a, b) if a.dtype.kind != "f" else
               np.allclose(a, b, rtol=1e-15) for a, b in zip(
                   C.to_coo(), jC.to_coo()))


def test_lattice_mass_and_background_matrices_match_reference(setting):
    space, jspace = setting["space"], setting["jspace"]
    lat, jlat = TLattice.for_space(space), JLattice.for_space(jspace)
    x = np.random.default_rng(6).standard_normal(lat.shape)
    assert rel_err(lat.mass(t(x)), jlat.mass(jnp.asarray(x))) <= 1e-14
    assert rel_err(lat.laplace(t(x)), jlat.laplace(jnp.asarray(x))) <= 1e-14
    for tf, jf in ((TA.mass_matrix, JA.mass_matrix),
                   (TA.laplace_matrix, JA.laplace_matrix)):
        coef = np.linspace(1.0, 2.0, space.grid.n_cells)
        m, jm = tf(space, coef=coef, **CPU), jf(jspace, coef=coef)
        y = np.random.default_rng(7).standard_normal(space.n_dofs)
        assert rel_err(m.mv(t(y)), jm.mv(jnp.asarray(y))) <= 1e-13
        assert rel_err(m.rmv(t(y)), jm.rmv(jnp.asarray(y))) <= 1e-13
        assert rel_err(m.diag(), jm.diag()) <= 1e-14
        assert rel_err(m.row_sums(), jm.row_sums()) <= 1e-14
        assert rel_err(m.to_dense(), jm.to_dense()) <= 1e-14
    plain = TA.mass_matrix(space, **CPU)
    assert rel_err(lat.mass(t(x)).reshape(-1),
                   plain.mv(t(x).reshape(-1))) <= 1e-13
    assert rel_err(lat.mass_diag(), plain.diag()) <= 1e-14


def test_h1_error_matches_reference(setting):
    space, jspace = setting["space"], setting["jspace"]
    u = np.sin(space.dof_points[:, 0]) * np.cos(space.dof_points[:, 1])

    def grad(p):
        p = np.asarray(p)
        return np.stack([np.cos(p[:, 0]) * np.cos(p[:, 1]),
                         -np.sin(p[:, 0]) * np.sin(p[:, 1])], axis=-1)

    def jgrad(p):
        return jnp.stack([jnp.cos(p[:, 0]) * jnp.cos(p[:, 1]),
                          -jnp.sin(p[:, 0]) * jnp.sin(p[:, 1])], axis=-1)

    assert TA.h1_error(space, t(u), grad) == pytest.approx(
        JA.h1_error(jspace, jnp.asarray(u), jgrad), rel=1e-12)


def test_linop_algebra():
    rng = np.random.default_rng(8)
    A, B = rng.standard_normal((4, 4)), rng.standard_normal((4, 4))
    x = rng.standard_normal(4)

    def op(m):
        mt = t(m)
        return TL.LinOp(lambda v: mt @ v, m.shape, lambda v: mt.T @ v)

    a, b = op(A), op(B)
    for got, ref in ((a + b, A + B), (a - b, A - B), (-a, -A),
                     (2.5 * a, 2.5 * A), (a @ b, A @ B)):
        assert rel_err(got(t(x)), ref @ x) <= 1e-14
        assert rel_err(got.T(t(x)), ref.T @ x) <= 1e-14
    assert rel_err(TL.identity(4)(t(x)), x) == 0.0
    z = TL.zero_op(3, 4)
    assert z(t(x)).shape == (3,) and float(z.T(t(x[:3])).abs().sum()) == 0.0
    assert (a + TL.LinOp(lambda v: v, (4, 4)))._rmv is None
    with pytest.raises(ValueError):
        TL.LinOp(lambda v: v, (4, 4)).T


def test_cg_tridiag_and_condition_number_match_reference():
    rng = np.random.default_rng(9)
    Q = np.linalg.qr(rng.standard_normal((30, 30)))[0]
    A = Q @ np.diag(np.linspace(1.0, 50.0, 30)) @ Q.T
    b = rng.standard_normal(30)
    x, info, (al, be) = TK.cg(lambda v: t(A) @ v, t(b), tol=1e-12,
                              max_steps=60, track_tridiag=True)
    jx, jinfo, (jal, jbe) = JK.cg(lambda v: jnp.asarray(A) @ v,
                                  jnp.asarray(b), tol=1e-12, max_steps=60,
                                  track_tridiag=True)
    k = info.iterations
    assert k == int(jinfo.iterations) and info.converged
    assert rel_err(x, jx) <= 1e-10
    assert rel_err(al[:k], np.asarray(jal)[:k]) <= 1e-10
    assert rel_err(be[:k - 1], np.asarray(jbe)[:k - 1]) <= 1e-9
    cond = TK.cg_condition_number(al, be, k)
    assert cond == pytest.approx(JK.cg_condition_number(jal, jbe, k),
                                 rel=1e-8)
    assert cond == pytest.approx(50.0, rel=1e-6)


@pytest.mark.parametrize("which", ["modified", "ideal"])
def test_al_preconditioners_match_reference(which):
    """Both elliptic AL preconditioners on random dense blocks."""
    rng = np.random.default_rng(10)
    n, m = 7, 4
    mats = dict(ct=rng.standard_normal((n, m)), M=rng.standard_normal((m, m)),
                W=rng.standard_normal((m, m)),
                A11=rng.standard_normal((n, n)),
                A22=rng.standard_normal((m, m)),
                aug=rng.standard_normal((n + m, n + m)))
    u = rng.standard_normal(n + 2 * m)

    def ops(conv):
        return {k: (lambda v, a=conv(a): a @ v) for k, a in mats.items()}

    to = ops(t)
    jo = ops(jnp.asarray)
    if which == "modified":
        p = TAL.al_preconditioner_modified(TLayout((n, m, m)), to["A11"],
                                           to["A22"], to["ct"], to["M"],
                                           to["W"], 2.0)
        jp = JAL.al_preconditioner_modified(JLayout((n, m, m)), jo["A11"],
                                            jo["A22"], jo["ct"], jo["M"],
                                            jo["W"], 2.0)
    else:
        p = TAL.al_preconditioner_ideal(TLayout((n, m, m)), to["aug"],
                                        to["ct"], to["M"], to["W"], 2.0)
        jp = JAL.al_preconditioner_ideal(JLayout((n, m, m)), jo["aug"],
                                         jo["ct"], jo["M"], jo["W"], 2.0)
    assert rel_err(p(t(u)), jp(jnp.asarray(u))) <= 1e-14


def test_prm_report_timer():
    from fictitious_domain_al_preconditioners_torch.utils.prm import (
        Params, dump_prm, parse_prm)
    from fictitious_domain_al_preconditioners_torch.utils.report import \
        ConvergenceTable
    from fictitious_domain_al_preconditioners_torch.utils.timer import \
        TimerOutput

    tree = parse_prm("subsection A\n  set x = 1 # c\n  set y = true\nend\n")
    p = Params(tree).enter("A")
    assert p.get_int("x") == 1 and p.get_bool("y") and p.get_float("z", 2.0)
    assert parse_prm(dump_prm(tree)) == tree
    table = ConvergenceTable()
    for e in (1.0, 0.5, 0.25):
        table.add_row(L2=e)
    table.evaluate_rates(["L2"])
    assert [r["L2.rate"] for r in table.rows] == ["", "1.00", "1.00"]
    timer = TimerOutput()
    with timer.scope("a"):
        pass
    assert timer.calls["a"] == 1 and "Total" in timer.summary()
