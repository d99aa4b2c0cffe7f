"""The port's host C++ setup routines (``native.py``, built from its own
``csrc/fdal_setup.cpp``) against their NumPy forms and the JAX package's
``native`` module, and the coupling tables built with and without them."""

import hashlib
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fictitious_domain_al_preconditioners_tpu.core as jcore
import fictitious_domain_al_preconditioners_tpu.core.generators as jgen
import fictitious_domain_al_preconditioners_torch.core as tcore
import fictitious_domain_al_preconditioners_torch.core.generators as tgen
from fictitious_domain_al_preconditioners_tpu import native as jnative
from fictitious_domain_al_preconditioners_tpu.ops.coupling import \
    build_coupling as j_build_coupling
from fictitious_domain_al_preconditioners_tpu.ops.sparse import \
    coo_dedup as j_numpy_dedup
from fictitious_domain_al_preconditioners_torch import native
from fictitious_domain_al_preconditioners_torch.ops import \
    coupling as tcoupling
from fictitious_domain_al_preconditioners_torch.ops.sparse import \
    coo_dedup as t_numpy_dedup

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")
TABLE = ("bg_dofs", "bg_phi", "imm_dofs", "imm_psi", "jxw")


def numpy_forms():
    """The port's entries and call sites with the library switched off."""
    return mock.patch.object(native, "available", lambda: False)


def _dir_hash(path):
    digest = hashlib.sha1()
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as fh:
            digest.update(name.encode() + fh.read())
    return digest.hexdigest()


def test_library_builds_into_the_port_build_dir():
    assert native.available()
    lib = native.build()
    assert os.path.dirname(lib) == os.path.join(ROOT, "build", "torch_native")
    assert os.path.basename(lib) == \
        f"libfdal_setup_{native.source_tag()}.so"


def test_a_fresh_build_leaves_native_untouched(tmp_path):
    before = _dir_hash(os.path.join(ROOT, "native"))
    so = os.path.join(ROOT, "native", "libfdal_setup.so")
    with open(so, "rb") as fh:
        so_before = hashlib.sha1(fh.read()).hexdigest()
    with mock.patch.object(native, "BUILD_DIR", str(tmp_path)):
        lib = native.build()
    assert os.path.dirname(lib) == str(tmp_path) and os.path.exists(lib)
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(lib)]
    with open(so, "rb") as fh:
        assert hashlib.sha1(fh.read()).hexdigest() == so_before
    assert _dir_hash(os.path.join(ROOT, "native")) == before


def test_a_failing_compiler_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    with mock.patch.object(native, "SOURCE", str(bad)), \
            mock.patch.object(native, "BUILD_DIR", str(tmp_path / "out")):
        with pytest.raises(RuntimeError, match="error"):
            native.build()
    assert not any((tmp_path / "out").iterdir())


def test_without_a_compiler_the_numpy_forms_run():
    native._library.cache_clear()
    try:
        with mock.patch.object(native, "_compiler", lambda: None):
            assert not native.available()
            rng = np.random.default_rng(7)
            idx = rng.integers(0, 9, size=(40, 4))
            phi, w = rng.standard_normal((40, 4)), rng.random(40)
            np.testing.assert_array_equal(
                native.accumulate_al(idx, phi, w, 9),
                tcoupling.accumulate_al(idx, phi, w, 9))
    finally:
        native._library.cache_clear()
    assert native.available()


@pytest.mark.parametrize("dim", [2, 3])
def test_locate_points(dim):
    g = tcore.UniformGrid.hyper_cube(dim, -1.0, 1.0, 4)
    rng = np.random.default_rng(dim)
    pts = rng.uniform(-1.05, 1.05, size=(2000, dim))
    args = (pts, np.asarray(g.origin), g.h, np.asarray(g.ncells))
    cells, ref = native.locate_points(*args)
    with numpy_forms():
        cells_np, ref_np = native.locate_points(*args)
    cells_g, ref_g = g.locate(pts)
    cells_j, ref_j = jnative.locate_points(*args)
    assert cells.dtype == np.int64 and ref.shape == (2000, dim)
    for c, r in ((cells_np, ref_np), (cells_g, ref_g), (cells_j, ref_j)):
        np.testing.assert_array_equal(cells, c)
        np.testing.assert_allclose(ref, r, rtol=0, atol=1e-14)


@pytest.mark.parametrize("dim,deg", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_tabulate(dim, deg):
    fe = tcore.FE(dim, deg)
    pts = np.random.default_rng(10 * dim + deg).random((300, dim))
    vals = native.tabulate(pts, fe.nodes_1d, dim)
    with numpy_forms():
        vals_np = native.tabulate(pts, fe.nodes_1d, dim)
    assert vals.shape == (300, (deg + 1) ** dim)
    for other in (vals_np, fe.tabulate(pts),
                  jnative.tabulate(pts, fe.nodes_1d, dim)):
        np.testing.assert_allclose(vals, other, rtol=0, atol=1e-14)


def test_coo_dedup():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 40, 3000)
    cols = rng.integers(0, 50, 3000)
    vals = rng.standard_normal(3000)
    r, c, v = native.coo_dedup(rows, cols, vals, 50)
    with numpy_forms():
        r_np, c_np, v_np = native.coo_dedup(rows, cols, vals, 50)
    ro, co, vo = jnative.coo_dedup(rows, cols, vals, 50)
    np.testing.assert_array_equal(r, ro)
    np.testing.assert_array_equal(c, co)
    np.testing.assert_array_equal(v, vo)
    for ro, co, vo in ((r_np, c_np, v_np),
                       t_numpy_dedup(rows, cols, vals, 50),
                       j_numpy_dedup(rows, cols, vals, 50)):
        np.testing.assert_array_equal(r, ro)
        np.testing.assert_array_equal(c, co)
        np.testing.assert_allclose(v, vo, rtol=0, atol=1e-14)


def test_accumulate_al():
    rng = np.random.default_rng(3)
    nq, nloc, m = 4000, 9, 300
    idx = rng.integers(0, m, size=(nq, nloc))
    phi = rng.standard_normal((nq, nloc))
    w = rng.random(nq)
    A = native.accumulate_al(idx, phi, w, m)
    with numpy_forms():
        A_np = native.accumulate_al(idx, phi, w, m)
    scale = np.abs(A_np).max()
    for other in (A_np, tcoupling.accumulate_al(idx, phi, w, m),
                  jnative.accumulate_al(idx, phi, w, m)):
        assert np.abs(A - other).max() <= 1e-12 * scale


def _circle_spaces(core, ref):
    g = core.UniformGrid.hyper_cube(2, 0.0, 1.0, ref)
    return core.GridSpace.q(g, 1), core.parametrized_curve(
        lambda p: np.stack([0.2 * np.cos(2 * np.pi * p[:, 0]) + 0.4,
                            0.2 * np.sin(2 * np.pi * p[:, 0]) + 0.4],
                           axis=1), ref).space(1)


def _elliptic_spaces(core, gen, cycle=0):
    """The spaces of the results table's elliptic rows at ``cycle``
    (background refinement 5 + cycle on [-1, 1]², the immersed box
    [-0.14, 0.44]² at 3 + cycle, on its lattice twin's numbering, as
    ``EllipticInterfaceProblem.setup`` builds them)."""
    grid = gen.background_grid_from_name("hyper_cube", "-1: 1: true", 2,
                                         5 + cycle)
    box = gen.background_grid_from_name("hyper_cube", "-0.14: 0.44: true",
                                        2, 3 + cycle)
    mesh = gen.immersed_mesh_from_name("hyper_cube", "-0.14: 0.44: true",
                                       2, 3 + cycle)
    twin = core.GridSpace.q(box, 1)
    return core.GridSpace.q(grid, 1), core.ImmersedSpace(
        mesh, twin.fe, twin.cell_dofs, twin.n_dofs)


@pytest.mark.parametrize("case", ["laplace@5", "elliptic@0"])
def test_coupling_table_equals_the_jax_package(case):
    # the orders of the two problems' couplings: the prm's 3, and the
    # elliptic problem's degree + 1
    if case == "laplace@5":
        (bg_t, imm_t), (bg_j, imm_j), order = (
            _circle_spaces(tcore, 5), _circle_spaces(jcore, 5), 3)
    else:
        (bg_t, imm_t), (bg_j, imm_j), order = (
            _elliptic_spaces(tcore, tgen), _elliptic_spaces(jcore, jgen), 2)
    tC = tcoupling.build_coupling(bg_t, imm_t, order, device="cpu")
    with numpy_forms():
        tC_np = tcoupling.build_coupling(bg_t, imm_t, order, device="cpu")
    jC = j_build_coupling(bg_j, imm_j, order)
    assert tC.shape == jC.shape == tC_np.shape
    for key in TABLE:
        t, t_np = tC.host[key], tC_np.host[key]
        j = np.asarray(getattr(jC, key))
        assert t.shape == j.shape == t_np.shape, key
        if "dofs" in key:
            np.testing.assert_array_equal(t, j)
            np.testing.assert_array_equal(t, t_np)
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-14)
            np.testing.assert_allclose(t, t_np, rtol=0, atol=1e-14)
    np.testing.assert_allclose(tC.host["bg_phi"].sum(axis=1), 1.0,
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("ref", [3, 5])
def test_compact_al_with_and_without_the_library(ref):
    bg, imm = _circle_spaces(tcore, ref)
    C = tcoupling.build_coupling(bg, imm, 3, device="cpu")
    gamma = 10.0 / imm.mesh.h_max
    op, diag = C.compact_al(gamma)
    with numpy_forms():
        op_np, diag_np = C.compact_al(gamma)
    assert op.rows == op_np.rows
    np.testing.assert_allclose(diag, diag_np, rtol=1e-12, atol=0)
    u = torch.as_tensor(np.random.default_rng(ref).standard_normal(
        bg.n_dofs))
    a, b = op(u).numpy(), op_np(u).numpy()
    assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
    # the JAX package's block over the same table
    bg_j, imm_j = _circle_spaces(jcore, ref)
    jop, jdiag = j_build_coupling(bg_j, imm_j, 3).compact_al(gamma)
    np.testing.assert_allclose(diag, np.asarray(jdiag), rtol=1e-12, atol=0)
    j = np.asarray(jop(jnp.asarray(u.numpy())))
    assert np.abs(a - j).max() <= 1e-12 * np.abs(j).max()
