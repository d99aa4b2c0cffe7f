"""K6 and the no-patch form of K2 in the PyTorch port against the JAX
package: the plain K6 against ``SeparableStencil2D(..., use_pallas=False)``
and ``LatticeOps.laplace`` in float64; the plain no-patch K2 against
``fused_chebyshev_2d(..., planes=None, interpret=True)`` in float32 with the
bounds of tests/test_fused_cheb.py; the CPU dispatch of both wrappers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.ops.pallas_kernels import (
    _masked_conv9_xla, fused_chebyshev_2d, laplace_stencil_2d as j_stencil,
    stencil_factors_2d)
from fictitious_domain_al_preconditioners_tpu.parallel.lattice import \
    LatticeOps as JLatticeOps
from fictitious_domain_al_preconditioners_torch.core import (GridSpace,
                                                             UniformGrid)
from fictitious_domain_al_preconditioners_torch.ops import kernels as K
from fictitious_domain_al_preconditioners_torch.parallel.lattice import \
    LatticeOps

torch.set_num_threads(1)

SHAPES = [(65, 65), (33, 47)]
# max |port - jax| / max |jax| per mode (tests/test_fused_cheb.py:209-245)
TOL = {"op": 2e-5, "smooth": 2e-5, "pre": 2e-5, "pre_r": 5e-5, "post": 5e-5}


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def lattice_h(shape):
    return (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))


@pytest.mark.parametrize("shape", SHAPES)
def test_k6_plain_matches_separable_stencil(shape):
    h = lattice_h(shape)
    u = np.random.default_rng(0).standard_normal(shape)
    ref = j_stencil(*h)(jnp.asarray(u), use_pallas=False)
    got = K.laplace_stencil_2d(torch.as_tensor(u), h)
    assert got.dtype == torch.float64
    assert rel_err(got, ref) <= 1e-12


@pytest.mark.parametrize("shape", SHAPES)
def test_k6_plain_matches_lattice_laplace(shape):
    """K6 is the unconstrained stiffness of ``LatticeOps.laplace`` in both
    packages; the port's CPU ``LatticeOps.laplace`` keeps the separable
    form."""
    ny, nx = shape
    space = GridSpace.q(UniformGrid(2, (0.0, 0.0), (1.0, 1.0),
                                    (nx - 1, ny - 1)), 1)
    lat = LatticeOps.for_space(space)
    assert lat.shape == shape
    u = np.random.default_rng(1).standard_normal(shape)
    jl = JLatticeOps(tuple(lat.h), tuple(lat.shape))
    ref = np.asarray(jl.laplace(jnp.asarray(u)))
    got = K.laplace_stencil_2d(torch.as_tensor(u), lat.h)
    assert rel_err(got, ref) <= 1e-12
    launches = K.LAUNCHES["laplace_stencil_2d"]
    assert rel_err(lat.laplace(torch.as_tensor(u)), ref) <= 1e-12
    assert K.LAUNCHES["laplace_stencil_2d"] == launches


def test_k6_interior_is_the_constant_stencil():
    """Away from the edges K6 is the 3x3 stencil of ``_conv9_pallas``; on
    interior points it agrees with K1 (whose mask only zeroes the edge
    values it reads)."""
    shape, h = (33, 47), lattice_h((33, 47))
    u = np.random.default_rng(2).standard_normal(shape)
    u[0], u[-1], u[:, 0], u[:, -1] = 0.0, 0.0, 0.0, 0.0
    K0, M0, K1, M1 = stencil_factors_2d(h)
    w = np.outer(K0, M1) + np.outer(M0, K1)
    k1 = np.asarray(_masked_conv9_xla(w, shape[0], shape[1], jnp.float64)(
        jnp.asarray(u)))
    got = K.laplace_stencil_2d(torch.as_tensor(u), h).numpy()
    assert rel_err(got[1:-1, 1:-1], k1[1:-1, 1:-1]) <= 1e-13


@pytest.mark.parametrize("mode", K.MODES)
@pytest.mark.parametrize("shape", [(65, 65), (97, 161)])
def test_k2_no_patch_plain_matches_fused_interpret(shape, mode):
    h = lattice_h(shape)
    lam = 1.2
    jfn = fused_chebyshev_2d(stencil_factors_2d(h), shape, None, None, lam,
                             degree=4, eig_ratio=30.0, dtype=jnp.float32,
                             interpret=True, mode=mode)
    st = K.AugmentedStencil2D(h, shape, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(shape).astype(np.float32)
    x0 = rng.standard_normal(shape).astype(np.float32)
    if mode == "post":
        ref = jfn(jnp.asarray(b), jnp.asarray(x0))
        got = K.fused_augmented_2d(mode, st, torch.as_tensor(b),
                                   torch.as_tensor(x0), lam_max=lam)
    else:
        ref = jfn(jnp.asarray(b))
        got = K.fused_augmented_2d(mode, st, torch.as_tensor(b), lam_max=lam)
    if mode == "pre":
        assert rel_err(got[0], ref[0]) <= TOL["pre"]
        assert rel_err(got[1], ref[1]) <= TOL["pre_r"]
    else:
        assert rel_err(got, ref) <= TOL[mode]


def test_k2_no_patch_is_the_constrained_stiffness():
    """Without planes ``op`` is K1 and D⁻¹ is 1/Kc on interior points: the
    unfused smoother's ``1/laplace_diag`` there, bit for bit in float64."""
    space = GridSpace.q(UniformGrid.hyper_cube(2, 0.0, 1.0, 5), 1)
    lat = LatticeOps.for_space(space)
    st = K.AugmentedStencil2D(lat.h, lat.shape, device="cpu",
                              dtype=torch.float64)
    assert not st.patched and st.box == (0, 0, 0, 0)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(lat.shape))
    np.testing.assert_array_equal(K.fused_augmented_2d("op", st, x).numpy(),
                                  K.masked_laplace_2d(x, lat.h).numpy())
    free = ~space.boundary_dof_mask([0, 1, 2, 3]).reshape(lat.shape)
    diag = lat.laplace_diag().reshape(lat.shape)
    np.testing.assert_array_equal(st.dinv.numpy()[free], 1.0 / diag[free])
    np.testing.assert_array_equal(st.dinv.numpy()[~free], 1.0)


def test_no_patch_stencil_checks_its_arguments():
    with pytest.raises(ValueError, match="without planes"):
        K.AugmentedStencil2D((0.1, 0.1), (11, 11), None, (2, 2, 3, 3),
                             device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="device"):
        K.AugmentedStencil2D((0.1, 0.1), (11, 11))


def test_cpu_wrappers_take_the_plain_versions():
    before = K._library.cache_info()
    launches = dict(K.LAUNCHES)
    shape, h = (33, 47), lattice_h((33, 47))
    st = K.AugmentedStencil2D(h, shape, device="cpu", dtype=torch.float64)
    b = torch.ones(shape, dtype=torch.float64)
    K.laplace_stencil_2d(b, h)
    for mode in K.MODES:
        K.fused_augmented_2d(mode, st, b, b if mode == "post" else None)
    assert K._library.cache_info() == before
    assert K.LAUNCHES == launches


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor that is not on the CPU never takes the plain version: K6 and
    the no-patch K2 launch their kernel (CUDA) or raise."""
    u = torch.empty((9, 9), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.laplace_stencil_2d(u, (0.125, 0.125))
    st = K.AugmentedStencil2D((0.125, 0.125), (9, 9), device="meta",
                              dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_augmented_2d("smooth", st, u)
