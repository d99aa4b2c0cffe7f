"""Host setup of the PyTorch port against the JAX package: quadrature, finite
elements, grid, immersed curve, parsed functions, the coupling table, the
Γ-band patch weights and the load vectors (float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fictitious_domain_al_preconditioners_tpu.core as jcore
import fictitious_domain_al_preconditioners_torch.core as tcore
from fictitious_domain_al_preconditioners_tpu.ops import assembly as jasm
from fictitious_domain_al_preconditioners_tpu.ops.coupling import \
    build_coupling as j_build_coupling
from fictitious_domain_al_preconditioners_tpu.utils.expressions import \
    ParsedFunction as JParsed
from fictitious_domain_al_preconditioners_torch.ops import assembly as tasm
from fictitious_domain_al_preconditioners_torch.ops.coupling import \
    build_coupling as t_build_coupling
from fictitious_domain_al_preconditioners_torch.utils.expressions import \
    ParsedFunction as TParsed

torch.set_num_threads(1)

CONF = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")
EXPRS = [("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
         ("if(x < .5, x^2, -y) + atan2(y, x+1) - max(x, y, .3)", ""),
         ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")]


def _curves(mod, ref):
    f = (TParsed if mod is tcore else JParsed)(*CONF)
    return mod.parametrized_curve(lambda p: np.asarray(f(p)), ref)


def _spaces(mod, ref):
    curve = _curves(mod, ref)
    grid = mod.UniformGrid.hyper_cube(2, 0.0, 1.0, ref)
    return curve, mod.GridSpace.q(grid, 1)


@pytest.mark.parametrize("dim,order", [(1, 2), (1, 3), (2, 2), (2, 3)])
def test_quadrature_and_fe(dim, order):
    a, b = jcore.gauss(dim, order), tcore.gauss(dim, order)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.weights, b.weights)
    for deg in (1, 2):
        fa, fb = jcore.FE(dim, deg), tcore.FE(dim, deg)
        np.testing.assert_array_equal(fa.tabulate(a.points),
                                      fb.tabulate(b.points))
        np.testing.assert_array_equal(fa.tabulate_grad(a.points),
                                      fb.tabulate_grad(b.points))


@pytest.mark.parametrize("ref", [4, 5])
def test_grid_and_curve(ref):
    jc, js = _spaces(jcore, ref)
    tc, ts = _spaces(tcore, ref)
    np.testing.assert_array_equal(js.cell_dofs, ts.cell_dofs)
    np.testing.assert_array_equal(js.dof_points, ts.dof_points)
    np.testing.assert_array_equal(js.boundary_dof_mask([0, 1, 2, 3]),
                                  ts.boundary_dof_mask([0, 1, 2, 3]))
    pts = np.random.default_rng(ref).uniform(0, 1, (50, 2))
    for x, y in zip(js.grid.locate(pts), ts.grid.locate(pts)):
        np.testing.assert_array_equal(x, y)
    assert jc.h_max == tc.h_max
    np.testing.assert_array_equal(jc.geom_nodes, tc.geom_nodes)
    ji, ti = jc.space(1), tc.space(1)
    assert ji.n_dofs == ti.n_dofs
    np.testing.assert_array_equal(ji.cell_dofs, ti.cell_dofs)
    rule = jcore.gauss(1, 3)
    for x, y in zip(jc.quad_geometry(rule), tc.quad_geometry(rule)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("expr", EXPRS)
def test_parsed_function(expr):
    jf, tf = JParsed(*expr), TParsed(*expr)
    _, space = _spaces(tcore, 4)
    rule = tcore.gauss(2, 3)
    quad = (space.dof_points[:40, None, :] * 0.9
            + rule.points[None, :, :] * 0.05).reshape(-1, 2)
    for pts in (space.dof_points, quad):
        np.testing.assert_allclose(tf(pts), np.asarray(jf(pts)),
                                   rtol=1e-14, atol=1e-14)
    tt = tf(torch.as_tensor(quad))
    assert isinstance(tt, torch.Tensor) and tt.dtype == torch.float64
    np.testing.assert_array_equal(tt.numpy(), tf(quad))


@pytest.mark.parametrize("ref", [4, 5])
def test_coupling_table_and_patch(ref):
    jc, js = _spaces(jcore, ref)
    tc, ts = _spaces(tcore, ref)
    jC = j_build_coupling(js, jc.space(1), 3)
    tC = t_build_coupling(ts, tc.space(1), 3, device="cpu")
    np.testing.assert_array_equal(np.asarray(jC.bg_dofs),
                                  tC.host["bg_dofs"])
    np.testing.assert_array_equal(np.asarray(jC.imm_dofs),
                                  tC.host["imm_dofs"])
    for k in ("bg_phi", "imm_psi", "jxw"):
        np.testing.assert_allclose(tC.host[k], np.asarray(getattr(jC, k)),
                                   rtol=1e-14, atol=1e-15)
    gamma = 10.0 / tc.h_max
    sp_j, sp_t = js, ts
    while sp_j.grid.ncells[0] >= 4:   # every GMG level of the flagship
        jw = j_build_coupling(sp_j, jc.space(1), 3).patch_w9(sp_j, gamma)
        tw = t_build_coupling(sp_t, tc.space(1), 3, device="cpu") \
            .patch_w9(sp_t, gamma)
        assert (jw is None) == (tw is None)
        if jw is not None:
            assert jw[0] == tw[0]
            np.testing.assert_allclose(tw[1], jw[1], rtol=1e-14, atol=1e-14)
        sp_j, sp_t = sp_j.coarse_space(), sp_t.coarse_space()


@pytest.mark.parametrize("ref", [4, 5])
def test_load_vectors_and_mass(ref):
    jc, js = _spaces(jcore, ref)
    tc, ts = _spaces(tcore, ref)
    f = EXPRS[0]
    jr = np.asarray(jasm.rhs_vector(js, JParsed(*f), order=2))
    tr = tasm.rhs_vector(ts, TParsed(*f), order=2, device="cpu").numpy()
    np.testing.assert_allclose(tr, jr, rtol=1e-14, atol=1e-14 * abs(jr).max())
    g = ("sin(2*pi*x)*sin(2*pi*y)", "")
    ji, ti = jc.space(1), tc.space(1)
    np.testing.assert_allclose(
        tasm.imm_rhs(ti, TParsed(*g), order=2, device="cpu").numpy(),
        np.asarray(jasm.imm_rhs(ji, JParsed(*g), order=2)),
        rtol=1e-14, atol=1e-16)
    tM = tasm.imm_mass_matrix(ti, order=2, device="cpu")
    jM = jasm.imm_mass_matrix(ji, order=2)
    np.testing.assert_allclose(tM.diag().numpy(), np.asarray(jM.diag()),
                               rtol=1e-14)
    lam = np.random.default_rng(ref).standard_normal(ti.n_dofs)
    np.testing.assert_allclose(tM.mv(torch.as_tensor(lam)).numpy(),
                               np.asarray(jM.mv(jnp.asarray(lam))),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(
        tasm.interpolate(ts, TParsed(*g), device="cpu").numpy(),
        np.asarray(jasm.interpolate(js, JParsed(*g))), rtol=1e-14,
        atol=1e-15)
    u = np.random.default_rng(ref).standard_normal(ts.n_dofs)

    def exact(p, xp=np):
        return xp.sin(2 * xp.pi * p[:, 0]) * xp.sin(2 * xp.pi * p[:, 1])

    np.testing.assert_allclose(
        tasm.l2_error(ts, torch.as_tensor(u), exact),
        jasm.l2_error(js, jnp.asarray(u), lambda p: exact(p, jnp)),
        rtol=1e-12)
