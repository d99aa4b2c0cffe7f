"""K2 in bf16 storage on the card (``csrc/fdal_sweep_bf16.cu``): every mode
against the float32 plain form on the same bf16 inputs and planes at the
edges of the sweep's tile (lattices one point either side of a multiple of
it, boxes on tile edges, across them and at the lattice border, the coarse
levels, degrees 2, 4 and 6) and at 4097² with the flagship's planes, there
also against the composition it replaces (K1 bf16 + ``patch_al_lattice`` +
``chebyshev`` in bf16); the bf16 flagship's launches (two a visit of every
level whose band is interior, no K1 there), its graphed V-cycle at
refinement 9 against the eager one, and its 4 outer iterations at
refinement 12.  Marked ``gpu``; without a card every test skips.  On the
card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_bf16_sweep.py
"""

import numpy as np
import pytest
import torch

import chip_smoke as S
from fictitious_domain_al_preconditioners_torch.models import \
    ImmersedLaplaceProblem
from fictitious_domain_al_preconditioners_torch.ops import kernels as K
from fictitious_domain_al_preconditioners_torch.parallel.lattice import \
    LatticeOps
from fictitious_domain_al_preconditioners_torch.precond.chebyshev import \
    chebyshev

pytestmark = pytest.mark.gpu

BF16 = torch.bfloat16
#: against the float32 plain form on the same bf16 inputs, before its
#: rounding: half a bf16 ulp of the largest output
ROUNDING = S.BF16_SWEEP_TOL
#: against the composition the bf16 V-cycle ran before (its bf16
#: arithmetic rounds every partial sum)
COMPOSITION = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


def _edge_cases():
    """(lattice, box or None, degree) at the edges of the sweep's output
    tile (ty x tx at that degree)."""
    cases = []
    for deg in (2, 4, 6):
        ty, tx = K.sweep_output_tile("pre", deg)
        for d in (-1, 1):
            shape = (4 * ty + d, 3 * tx - d)
            cases += [(shape, None, deg),
                      (shape, (ty, tx, 2 * ty, tx), deg),
                      (shape, (ty - 1, tx + 1, 2 * ty + 2, tx - 2), deg),
                      (shape, (0, 0, 3 * ty, tx), deg),
                      (shape, (ty, 1, shape[0] - ty, shape[1] - 1), deg)]
    for n in (5, 9, 17):
        cases += [((n, n), None, 4), ((n, n), (0, 0, n, n), 4),
                  ((n, n), (1, 2, n - 2, n - 3), 2)]
    return cases


def _stencil(device, shape, box):
    h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    if box is None:
        return K.AugmentedStencil2D(h, shape, device=device, dtype=BF16)
    st = S.random_patch_stencil(shape, box, device, seed=sum(box))
    return K.AugmentedStencil2D(h, shape, st.planes.to(BF16), box)


def _modes(st, b, x0, **kw):
    """Every mode's outputs of the kernel and of the float32 plain form on
    the same inputs, as (mode, got, ref) triples."""
    out = []
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        got = K.fused_augmented_2d(mode, st, b, xin, **kw)
        ref = K.fused_augmented_2d_plain(
            mode, st.float32, b.float(), None if xin is None else xin.float(),
            **kw)
        pairs = zip(got, ref) if mode == "pre" else [(got, ref)]
        out += [(mode, g, r) for g, r in pairs]
    return out


@pytest.mark.parametrize("shape,box,degree", _edge_cases())
def test_bf16_sweep_matches_plain_at_tile_edges(cuda, shape, box, degree):
    """Each mode within :data:`ROUNDING` of the float32 plain form, in bf16,
    the boundary of ``op`` the input bit for bit, the input left as it was;
    one launch a call under the mode's bf16 key, none under a float32
    key."""
    st = _stencil(cuda, shape, box)
    rng = np.random.default_rng(4)
    b = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=cuda).to(BF16)
    x0 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=cuda).to(BF16)
    kept = b.clone()
    before = dict(K.LAUNCHES)
    for mode, got, ref in _modes(st, b, x0, lam_max=1.5, degree=degree):
        assert got.dtype == BF16 and tuple(got.shape) == shape
        assert _rel(got, ref) <= ROUNDING, mode
    torch.cuda.synchronize()
    assert torch.equal(b.view(torch.int16), kept.view(torch.int16))
    op = K.fused_augmented_2d("op", st, b)
    for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        assert torch.equal(op[edge].contiguous().view(torch.int16),
                           b[edge].contiguous().view(torch.int16))
    for m in K.MODES:
        key = K.launch_key(m, st.patched, bf16=True)
        assert K.LAUNCHES[key] == before[key] + 1 + (m == "op")
        assert K.LAUNCHES[K.launch_key(m)] == before[K.launch_key(m)]


def _flagship(device, refinement):
    return ImmersedLaplaceProblem(S.flagship_config(refinement, bf16=True),
                                  device=device).setup()


@pytest.fixture(scope="module")
def flagship12():
    """The bf16 flagship at refinement 12, solved once (the warm solve)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prob = _flagship(torch.device("cuda", 0), 12)
    prob.solve()
    return prob


def test_bf16_sweep_at_4097_against_plain_and_composition(cuda, flagship12):
    """The fine level of the bf16 flagship (4097², its planes and Lanczos
    bound): every mode within :data:`ROUNDING` of the float32 plain form;
    ``op``, ``smooth`` and ``pre``'s x within :data:`COMPOSITION` of the
    composition it replaces, ``pre``'s residual and ``post`` (where that
    composition's rounding reaches several percent) nearer the float64
    result than it."""
    prob = flagship12
    st = prob.level_stencils[0]
    level = prob._last_gmg.levels[0]
    assert st is not None and st.dtype == BF16 and st.shape == (4097, 4097)
    rng = np.random.default_rng(12)
    b = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                        device=cuda).to(BF16)
    x0 = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                         device=cuda).to(BF16)
    kw = dict(lam_max=level.lam_max, degree=4, eig_ratio=30.0)
    got = {}
    for mode, g, r in _modes(st, b, x0, **kw):
        assert _rel(g, r) <= ROUNDING, mode
        got.setdefault(mode, []).append(g)
    gamma, _, _, _, coupling = prob._al_form()
    space = prob.space
    lat = LatticeOps.for_space(space)
    free = ~space.boundary_dof_mask([0, 1, 2, 3])
    mv2, _ = coupling.patch_al_lattice(space, gamma, free=free, dtype=BF16)

    def old_op(x):
        return K.masked_laplace_2d(x, lat.h) + mv2(x)

    old = chebyshev(old_op, level.diag_inv, level.lam_max, degree=4,
                    eig_ratio=30.0)
    xo = old(b)
    assert _rel(got["op"][0], old_op(b)) <= COMPOSITION
    assert _rel(got["smooth"][0], xo) <= COMPOSITION
    assert _rel(got["pre"][0], xo) <= COMPOSITION
    st64 = K.AugmentedStencil2D(st.h, st.shape, st.planes.double(), st.box)
    _, t_r = K.fused_augmented_2d_plain("pre", st64, b.double(), **kw)
    t_post = K.fused_augmented_2d_plain("post", st64, b.double(),
                                        x0.double(), **kw)
    for new, was, truth in ((got["pre"][1], b - old_op(xo), t_r),
                            (got["post"][0], x0 + old(b - old_op(x0)),
                             t_post)):
        assert _rel(new, truth) <= ROUNDING
        assert _rel(new, truth) < _rel(was, truth)


def test_two_bf16_launches_a_level_visit(cuda, flagship12):
    """One V-cycle of the bf16 flagship (level 0 eager, the tail replayed
    from its graph) launches K2 bf16 ``pre`` and ``post`` once at every
    level whose band is interior, no K2 bf16 ``op`` and no K1 bf16 there;
    every level above the coarsest has its band inside."""
    gmg = flagship12._last_gmg
    stencils = flagship12.level_stencils
    interior = sum(st is not None for st in stencils[:-1])
    assert interior == len(gmg.levels) - 1
    assert isinstance(gmg._graph, torch.cuda.CUDAGraph)
    fine = gmg.levels[0].mask
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(
        tuple(fine.shape)), dtype=torch.float32, device=cuda) * fine.float()
    K.reset_launch_counts()
    gmg.apply(b)
    torch.cuda.synchronize()
    assert K.LAUNCHES[K.launch_key("pre", bf16=True)] == interior
    assert K.LAUNCHES[K.launch_key("post", bf16=True)] == interior
    assert K.LAUNCHES[K.launch_key("op", bf16=True)] == 0
    assert K.LAUNCHES["masked_laplace_2d:bf16"] == 0


def test_bf16_flagship_keeps_four_outer_iterations(flagship12):
    """The bf16 flagship at refinement 12 (16.8M + 4,097 dofs) converges
    in 4 outer iterations, as with the unfused bf16 smoother."""
    flagship12.solve()
    assert flagship12.results["converged"]
    assert flagship12.results["outer_iterations"] == 4


def test_graphed_bf16_vcycle_is_the_eager_one(cuda):
    """At refinement 9 the bf16 V-cycle replayed from its graph equals the
    eager recursion to :data:`ROUNDING` of its largest entry."""
    prob = _flagship(cuda, 9)
    prob.solve()
    gmg = prob._last_gmg
    assert isinstance(gmg._graph, torch.cuda.CUDAGraph)
    fine = gmg.levels[0].mask
    rng = np.random.default_rng(9)
    for _ in range(3):
        b = torch.as_tensor(rng.standard_normal(tuple(fine.shape)),
                            dtype=torch.float32, device=cuda) * fine.float()
        got = gmg.apply(b)
        gmg._below = lambda rc: gmg._vcycle(1, rc)
        try:
            ref = gmg.apply(b)
        finally:
            del gmg._below
        assert _rel(got, ref) <= ROUNDING
