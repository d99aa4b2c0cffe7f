"""K2 in bf16 storage on the CPU: the bf16 V-cycle's levels whose Γ-band is
interior are K2 (``op`` and the fused ``pre``/``post`` smoother) with bf16
planes, the others K1's bf16 form plus the compact AL block with the
unfused Chebyshev; K2's five symmetric planes are the masked 9-weight patch
of ``Coupling.patch_al_lattice``; the bf16 plain form is the float32 form
rounded once; and the levels agree with the composition they replace (K1
bf16 + the bf16 patch + ``chebyshev`` in bf16 arithmetic) within bf16
rounding, and lie nearer the float64 result than it does.  No JAX: the
bf16 V-cycle against the JAX package is tests/test_torch_bf16.py."""

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_torch.core import (
    GridSpace, UniformGrid, parametrized_curve)
from fictitious_domain_al_preconditioners_torch.models import \
    ImmersedLaplaceProblem
from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
    import _PLANES
from fictitious_domain_al_preconditioners_torch.ops import kernels as K
from fictitious_domain_al_preconditioners_torch.ops.coupling import \
    build_coupling
from fictitious_domain_al_preconditioners_torch.parallel.dryrun import (
    CIRCLE, flagship_config)
from fictitious_domain_al_preconditioners_torch.parallel.lattice import \
    LatticeOps
from fictitious_domain_al_preconditioners_torch.precond.chebyshev import \
    chebyshev
from fictitious_domain_al_preconditioners_torch.precond.gmg import \
    FusedSmoother
from fictitious_domain_al_preconditioners_torch.utils import ParsedFunction

torch.set_num_threads(1)

BF16 = torch.bfloat16
#: the bf16 level against the float64 result on the same bf16 inputs and
#: planes: half a bf16 ulp of the largest output (one rounding a store)
ROUNDING = 2.0 ** -8
#: the bf16 level against the composition it replaces, whose bf16
#: arithmetic rounds every partial sum (K1 bf16 against the reference's
#: bf16 arithmetic: 3e-2, tests/test_torch_bf16.py)
COMPOSITION = 3e-2
KW = dict(degree=4, eig_ratio=30.0)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def _coupling(ref):
    """The flagship circle's space, coupling table and γ at ``ref``."""
    f = ParsedFunction(*CIRCLE)
    curve = parametrized_curve(lambda p: np.asarray(f(p)), ref)
    space = GridSpace.q(UniformGrid.hyper_cube(2, 0.0, 1.0, ref), 1)
    C = build_coupling(space, curve.space(1), 3, device="cpu")
    return space, C, 10.0 / curve.h_max


@pytest.mark.parametrize("ref", [4, 5, 6])
def test_planes_are_the_masked_lattice_patch(ref):
    """On an interior band K2's five symmetric planes, mirrored, are
    ``patch_w9``'s nine weights with the Dirichlet mask baked in (the
    weights ``patch_al_lattice`` applies), and zero on the ring around the
    box, where K2's plain ``op`` evaluates the patch (that ``op`` is K1 plus
    ``patch_al_lattice``'s apply: tests/test_torch_kernels.py)."""
    space, C, gamma = _coupling(ref)
    free = ~space.boundary_dof_mask([0, 1, 2, 3])
    box, w9 = C.patch_w9(space, gamma)
    _, w9_free = C.patch_w9(space, gamma, free=free)
    planes = torch.as_tensor(np.stack([w9[a, b] for a, b in _PLANES]))
    lat = LatticeOps.for_space(space)
    st = K.AugmentedStencil2D(lat.h, lat.shape, planes, box)
    grown = st.w9.numpy()
    scale = np.abs(w9_free).max()
    np.testing.assert_allclose(grown[:, :, 1:-1, 1:-1], w9_free, rtol=0,
                               atol=1e-13 * scale)
    ring = grown.copy()
    ring[:, :, 1:-1, 1:-1] = 0.0
    assert not ring.any()


def test_bf16_plain_form_is_the_float32_form_rounded_once():
    """The bf16 plain form of every mode: the float32 plain form on the
    widened inputs and planes, each output rounded to bf16 once (the
    kernel's semantics); the CPU wrapper returns it."""
    space, C, gamma = _coupling(5)
    box, w9 = C.patch_w9(space, gamma)
    planes = torch.as_tensor(np.stack([w9[a, b] for a, b in _PLANES]))
    lat = LatticeOps.for_space(space)
    st = K.AugmentedStencil2D(lat.h, lat.shape, planes.to(BF16), box)
    assert st.float32.planes.dtype == torch.float32
    assert torch.equal(st.float32.planes.to(BF16), st.planes)
    rng = np.random.default_rng(3)
    b = torch.as_tensor(rng.standard_normal(lat.shape)).to(BF16)
    x0 = torch.as_tensor(rng.standard_normal(lat.shape)).to(BF16)
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        got = K.fused_augmented_2d(mode, st, b, xin, lam_max=1.5, **KW)
        ref = K.fused_augmented_2d_plain(
            mode, st.float32, b.float(), None if xin is None else xin.float(),
            lam_max=1.5, **KW)
        pairs = zip(got, ref) if mode == "pre" else [(got, ref)]
        for g, r in pairs:
            assert g.dtype == BF16
            assert torch.equal(g, r.to(BF16)), mode
    assert {K.launch_key(m, p, True) for m in K.MODES for p in (True, False)
            } <= set(K.LAUNCHES)
    assert K.launch_key("pre", bf16=True) == "fused_augmented_2d:pre:bf16"


def _bf16_levels(ref):
    """The bf16 flagship's hierarchy at ``ref`` (float64 outer, CPU): the
    problem, its GMG, and each level's coupling (for the composition)."""
    cfg = flagship_config(ref)
    cfg.use_bf16_multigrid = True
    prob = ImmersedLaplaceProblem(cfg, device="cpu").setup()
    prob._augmented_run()
    gamma, _, _, coupling_for, fine = prob._al_form()
    gmg = prob._last_gmg
    couplings = [fine if i == 0 else coupling_for(lv.space)
                 for i, lv in enumerate(gmg.levels)]
    return prob, gmg, couplings, gamma


@pytest.fixture(scope="module", params=[4, 5, 6])
def levels(request):
    return _bf16_levels(request.param)


def test_level_routes_by_band(levels):
    """Where ``patch_w9`` gives an interior band the bf16 level carries K2's
    stencil with bf16 planes and the fused smoother; where the band touches
    ∂Ω (the coarsest levels) no stencil and the unfused Chebyshev."""
    prob, gmg, couplings, gamma = levels
    kinds = set()
    for lv, st, C in zip(gmg.levels, prob.level_stencils, couplings):
        interior = C.patch_w9(lv.space, gamma) is not None
        kinds.add(interior)
        assert (st is not None) == interior
        if interior:
            assert st.dtype == BF16 and st.planes.dtype == BF16
            assert st.shape == tuple(lv.mask.shape)
            assert isinstance(lv.smoother, FusedSmoother)
            assert lv.smoother.pre is not None
            assert lv.smoother.post is not None
        else:
            assert not isinstance(lv.smoother, FusedSmoother)
    assert kinds == {True, False}


def test_level_matches_the_unfused_composition(levels):
    """Each K2 level's ``op`` and smoother against the composition the bf16
    V-cycle ran before (K1 bf16 + ``patch_al_lattice`` in bf16, the unfused
    ``chebyshev`` in bf16 arithmetic) on the same bf16 vectors: the
    operator, ``smooth`` and ``pre``'s x within :data:`COMPOSITION`; ``pre``'s
    residual and ``post``, where the composition's own rounding reaches
    several percent of the output (cancellation), lie within
    :data:`ROUNDING` of the float64 result on the same bf16 inputs and
    planes, and nearer it than the composition.  Every output is bf16."""
    prob, gmg, couplings, gamma = levels
    checked = 0
    for i, (lv, st, C) in enumerate(zip(gmg.levels, prob.level_stencils,
                                        couplings)):
        if st is None:
            continue
        sp = lv.space
        lat = LatticeOps.for_space(sp)
        free = ~sp.boundary_dof_mask([0, 1, 2, 3])
        mv2, _ = C.patch_al_lattice(sp, gamma, free=free, dtype=BF16)

        def old_op(x):
            return K.masked_laplace_2d(x, lat.h) + mv2(x)

        old = chebyshev(old_op, lv.diag_inv, lv.lam_max, **KW)
        st64 = K.AugmentedStencil2D(st.h, st.shape, st.planes.double(),
                                    st.box)
        kw = dict(lam_max=lv.lam_max, **KW)
        rng = np.random.default_rng(40 + i)
        x = torch.as_tensor(rng.standard_normal(lat.shape)).to(BF16)
        x0 = torch.as_tensor(rng.standard_normal(lat.shape)).to(BF16)

        new_op = lv.op(x)
        xs, r = lv.smoother.pre(x)
        post = lv.smoother.post(x, x0)
        for out in (new_op, xs, r, post, lv.smoother(x)):
            assert out.dtype == BF16
        xo = old(x)
        assert _rel(new_op, old_op(x)) <= COMPOSITION
        assert _rel(xs, xo) <= COMPOSITION
        assert _rel(lv.smoother(x), xo) <= COMPOSITION

        t_op = K.fused_augmented_2d_plain("op", st64, x.double())
        t_x, t_r = K.fused_augmented_2d_plain("pre", st64, x.double(), **kw)
        t_post = K.fused_augmented_2d_plain("post", st64, x.double(),
                                            x0.double(), **kw)
        assert _rel(new_op, t_op) <= ROUNDING
        assert _rel(xs, t_x) <= ROUNDING
        for new, was, truth in ((r, x - old_op(xo), t_r),
                                (post, x0 + old(x - old_op(x0)), t_post)):
            assert _rel(new, truth) <= ROUNDING
            assert _rel(new, truth) < _rel(was, truth)
        checked += 1
    assert checked >= 2
