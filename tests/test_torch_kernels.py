"""Plain PyTorch versions of the port's kernels against the JAX package's
forms: K1 against ``_masked_conv9_xla``, K2 in all four modes against
``fused_chebyshev_2d(interpret=True)`` (float32, the tolerances of
tests/test_fused_cheb.py); the CPU dispatch rule of the wrappers; and the
D⁻¹ identity between the fused and the unfused smoother."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.ops.pallas_kernels import (
    _masked_conv9_xla, fused_chebyshev_2d, stencil_factors_2d)
from fictitious_domain_al_preconditioners_torch.core import (
    GridSpace, UniformGrid, parametrized_curve)
from fictitious_domain_al_preconditioners_torch.ops import kernels as K
from fictitious_domain_al_preconditioners_torch.ops.coupling import \
    build_coupling
from fictitious_domain_al_preconditioners_torch.parallel.lattice import \
    LatticeOps
from fictitious_domain_al_preconditioners_torch.utils import ParsedFunction

torch.set_num_threads(1)

CONF = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")
PLANES = ((1, 1), (1, 2), (2, 1), (2, 2), (2, 0))
# max |port - jax| / max |jax| per mode (tests/test_fused_cheb.py)
TOL = {"op": 2e-5, "smooth": 2e-5, "pre": 2e-5, "pre_r": 5e-5, "post": 5e-5}


def flagship_patch(ref):
    f = ParsedFunction(*CONF)
    curve = parametrized_curve(lambda p: np.asarray(f(p)), ref)
    space = GridSpace.q(UniformGrid.hyper_cube(2, 0.0, 1.0, ref), 1)
    C = build_coupling(space, curve.space(1), 3, device="cpu")
    return space, C, 10.0 / curve.h_max


def synthetic_patch(ny, nx, rng, nq=300):
    """Symmetric Γ-band patch with the structure of ``Coupling.patch_w9``
    (bilinear hats at points of a circle) on an (ny, nx) lattice."""
    s = rng.uniform(0, 2 * np.pi, nq)
    fy = (0.5 + 0.3 * np.sin(s)) * (ny - 1)
    fx = (0.5 + 0.3 * np.cos(s)) * (nx - 1)
    cy, cx = np.floor(fy).astype(int), np.floor(fx).astype(int)
    ty, tx = fy - cy, fx - cx
    corners = [(0, 0), (0, 1), (1, 0), (1, 1)]
    phi = np.stack([(ty if dy else 1 - ty) * (tx if dx else 1 - tx)
                    for dy, dx in corners], axis=1)
    jxw = rng.uniform(0.5, 1.5, nq) / ny
    rows = np.stack([cy + dy for dy, _ in corners], axis=1)
    cols = np.stack([cx + dx for _, dx in corners], axis=1)
    loc = jxw[:, None, None] * phi[:, :, None] * phi[:, None, :]
    r0, c0 = int(rows.min()), int(cols.min())
    pr, pc = int(rows.max()) - r0 + 1, int(cols.max()) - c0 + 1
    w9 = np.zeros((3, 3, pr, pc))
    for i in range(4):
        for j in range(4):
            np.add.at(w9, (rows[:, j] - rows[:, i] + 1,
                           cols[:, j] - cols[:, i] + 1,
                           rows[:, i] - r0, cols[:, i] - c0), loc[:, i, j])
    return (r0, c0, pr, pc), 10.0 * ny * w9


def case(name):
    """(h, (ny, nx), box, w9) of a test lattice."""
    if name == "n65":
        space, C, gamma = flagship_patch(6)
        box, w9 = C.patch_w9(space, gamma)
        return (1 / 64, 1 / 64), (65, 65), box, w9
    box, w9 = synthetic_patch(97, 161, np.random.default_rng(5))
    return (1 / 96, 1 / 160), (97, 161), box, w9


def planes_of(w9):
    return np.stack([w9[a, b] for a, b in PLANES]).astype(np.float32)


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("name", ["n65", "n97x161"])
def test_k1_plain_matches_xla(name):
    h, shape, _, _ = case(name)
    u = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    K0, M0, K1, M1 = stencil_factors_2d(h)
    w = np.outer(K0, M1) + np.outer(M0, K1)
    ref = _masked_conv9_xla(w, shape[0], shape[1], jnp.float32)(
        jnp.asarray(u))
    got = K.masked_laplace_2d(torch.as_tensor(u), h)
    assert got.dtype == torch.float32
    assert rel_err(got, ref) <= 1e-6


@pytest.mark.parametrize("mode", K.MODES)
@pytest.mark.parametrize("name", ["n65", "n97x161"])
def test_k2_plain_matches_fused_interpret(name, mode):
    h, shape, box, w9 = case(name)
    r0, c0, pr, pc = box
    planes = planes_of(w9)
    full = np.zeros((5,) + shape, np.float32)
    full[:, r0:r0 + pr, c0:c0 + pc] = planes
    lam = 1.2
    jfn = fused_chebyshev_2d(stencil_factors_2d(h), shape, full, box, lam,
                             degree=4, eig_ratio=30.0, dtype=jnp.float32,
                             interpret=True, mode=mode)
    st = K.AugmentedStencil2D(h, shape, torch.as_tensor(planes), box)
    rng = np.random.default_rng(2)
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


def test_k2_plain_op_is_k1_plus_patch_al_lattice():
    """In float64 the K2 plain ``op`` is K1-plain plus the masked
    ``patch_al_lattice`` (the composition the reference runs off the TPU)."""
    space, C, gamma = flagship_patch(5)
    lat = LatticeOps.for_space(space)
    free = ~space.boundary_dof_mask([0, 1, 2, 3])
    mv2, _ = C.patch_al_lattice(space, gamma, free=free)
    box, w9 = C.patch_w9(space, gamma)
    st = K.AugmentedStencil2D(
        lat.h, lat.shape,
        torch.as_tensor(np.stack([w9[a, b] for a, b in PLANES])), box)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(lat.shape))
    ref = K.masked_laplace_2d_plain(x, lat.h) + mv2(x)
    assert rel_err(K.fused_augmented_2d("op", st, x), ref) <= 1e-14


@pytest.mark.parametrize("ref", [5, 7])
def test_dinv_identity(ref):
    """D⁻¹ of the fused smoother, 1/(Kc + w_c), equals the unfused
    smoother's 1/(laplace_diag + al_diag) on every interior point of every
    GMG level that has a patch."""
    space, _, gamma = flagship_patch(ref)
    f = ParsedFunction(*CONF)
    imm = parametrized_curve(lambda p: np.asarray(f(p)), ref).space(1)
    sp = space
    checked = 0
    while sp.grid.ncells[0] >= 4:
        C = build_coupling(sp, imm, 3, device="cpu")
        pw = C.patch_w9(sp, gamma)
        if pw is not None:
            box, w9 = pw
            lat = LatticeOps.for_space(sp)
            free = ~sp.boundary_dof_mask([0, 1, 2, 3])
            _, al_diag = C.patch_al_lattice(sp, gamma, free=free)
            unfused = (lat.laplace_diag() + al_diag).reshape(lat.shape)
            st = K.AugmentedStencil2D(
                lat.h, lat.shape,
                torch.as_tensor(np.stack([w9[a, b] for a, b in PLANES])), box)
            m = free.reshape(lat.shape)
            np.testing.assert_array_equal(st.dinv.numpy()[m],
                                          1.0 / unfused[m])
            checked += 1
        sp = sp.coarse_space()
    assert checked >= 2


def test_cpu_wrappers_never_touch_the_cuda_loader():
    before = K._library.cache_info()
    launches = dict(K.LAUNCHES)
    h, shape, box, w9 = case("n65")
    st = K.AugmentedStencil2D(h, shape, torch.as_tensor(planes_of(w9)), box)
    b = torch.ones(shape)
    K.masked_laplace_2d(b, h)
    for mode in K.MODES:
        K.fused_augmented_2d(mode, st, b, b if mode == "post" else None)
    assert K._library.cache_info() == before
    assert K.LAUNCHES == launches


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches the kernel (CUDA) or raises."""
    u = torch.empty((9, 9), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.masked_laplace_2d(u, (0.125, 0.125))
    planes = torch.zeros((5, 3, 3), device="meta")
    st = K.AugmentedStencil2D((0.125, 0.125), (9, 9), planes, (3, 3, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_augmented_2d("op", st, u)
