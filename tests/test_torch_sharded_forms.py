"""The sharded augmented solve of the PyTorch port
(``ImmersedLaplaceProblem.build_sharded_solver``) in the lattice
configurations beside the flagship's (operator form, W = diag(M)): the exact
W = M, the explicit forms with W = diag(M)² and W = M², the bf16 V-cycle
and a fine Γ-band that touches ∂Ω (the flagship circle at refinement 2,
whose hierarchy is one level), on 2 gloo ranks (the explicit form also on
3, uneven blocks), in float64 on the CPU with the JAX package's setup state
and Lanczos vectors carried, held to the JAX package solving in the test
(the bf16 V-cycle to the port's serial bf16 solve); the JAX package's own
sharded solver on its 8-device virtual mesh against the port on 4 ranks;
and the row-block forms of the compact AL block and of K2's clipped patch
against the whole lattice's.

The ranks run while the JAX package solves (they need only its setup
state), so the file takes about the time of the JAX compiles."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models.immersed_laplace import (
    ImmersedLaplaceConfig as JConfig, ImmersedLaplaceProblem as JProblem,
    SolverControlConfig as JControl)
from fictitious_domain_al_preconditioners_torch.core import (
    GridSpace, UniformGrid, parametrized_curve)
from fictitious_domain_al_preconditioners_torch.models import \
    ImmersedLaplaceProblem as TProblem
from fictitious_domain_al_preconditioners_torch.ops.coupling import \
    build_coupling
from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
    import _PLANES
from fictitious_domain_al_preconditioners_torch.ops.kernels import (
    AugmentedStencil2D, fused_augmented_2d)
from fictitious_domain_al_preconditioners_torch.parallel import launch
from fictitious_domain_al_preconditioners_torch.parallel.dryrun import (
    flagship_config, sharded_flagship_rank, sharded_runs_rank)
from fictitious_domain_al_preconditioners_torch.parallel.mesh import (
    HALO, row_partition, sweep_halo)
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax
from test_torch_bf16 import bf16_carried_arrays
from test_torch_immersed_laplace import carried_arrays

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-11
BF16 = torch.bfloat16


def form(ref, operator=True, diagonal=True, bf16=False):
    cfg = flagship_config(ref)
    cfg.use_operator_form = operator
    cfg.use_diagonal_inverse = diagonal
    cfg.use_bf16_multigrid = bf16
    return cfg


CONFIGS = {"exact_w": form(4, diagonal=False),
           "explicit": form(4, operator=False),
           "explicit_exact_w": form(4, operator=False, diagonal=False),
           "band_on_boundary": form(2),
           "bf16": form(4, bf16=True)}
# the kind of each distributed level (fine first): K2 on an interior band
# (in bf16 storage in the bf16 V-cycle), K1 + the compact rows in the
# explicit form and on a band on ∂Ω
KINDS = {"exact_w": ["k2"], "explicit": ["k1"], "explicit_exact_w": ["k1"],
         "band_on_boundary": ["k1"], "bf16": ["k2"]}
UNEVEN = "explicit"


def jax_config(cfg):
    """The JAX package's configuration of a port configuration (the same
    fields)."""
    fields = dataclasses.asdict(cfg)
    fields["schur"] = JControl(**fields["schur"])
    return JConfig(**fields)


def _ranks(pool, runs, explicit):
    """The 2-rank runs, and the 3- and 4-rank runs of one configuration
    beside them."""
    two = pool.submit(launch, sharded_runs_rank, 2, backend="gloo",
                      device="cpu", args=(runs,), timeout=600)
    more = [launch(sharded_flagship_rank, n, backend="gloo", device="cpu",
                   args=explicit, timeout=600) for n in (3, 4)]
    return two.result(), *more


@pytest.fixture(scope="module")
def solved():
    """Every configuration on 2 ranks, the explicit form on 3 and 4, the
    JAX package's serial solves and its sharded explicit solve, and the
    port's serial bf16 solve."""
    from fictitious_domain_al_preconditioners_tpu.parallel import \
        make_mesh as j_make_mesh

    jps = {k: JProblem(jax_config(c)).setup() for k, c in CONFIGS.items()}
    arrays = {k: bf16_carried_arrays(jp) if k == "bf16"
              else carried_arrays(jp, matrices=True)
              for k, jp in jps.items()}
    runs = [(CONFIGS[k], arrays[k]) for k in CONFIGS]
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(_ranks, pool, runs,
                            (CONFIGS[UNEVEN], arrays[UNEVEN]))
        jax = {}
        for k, jp in jps.items():
            if k != "bf16":
                u, lam, info = jp.solve()
                jax[k] = (int(info.iterations), np.asarray(u), np.asarray(lam))
        jp = jps[UNEVEN]
        u, lam, info = jp.build_sharded_solver(j_make_mesh(8))(
            jp.rhs_f, jp.rhs_g, jp.bc_values)
        jax_sharded = (int(info.iterations), np.asarray(u), np.asarray(lam))
        tp = TProblem(CONFIGS["bf16"], device="cpu").setup()
        tp.load_state(state_from_jax(arrays["bf16"], "cpu", torch.float64))
        u, lam, info = tp.solve()
        bf16 = (info.iterations, u.numpy(), lam.numpy())
        two, three, four = ranks.result()
    return dict(two=dict(zip(CONFIGS, zip(*two))), three=three, four=four,
                jax=jax, jax_sharded=jax_sharded, bf16=bf16)


def check(res, ref, ranks, moves="halo_exchanges", max_rel=None):
    """Every rank's result against ``ref = (outer count, u, λ)``; the rows
    of the level vectors ``moves`` between the ranks (by halo exchanges on
    the lattice, all-gathers on the element form).  u and λ within
    ``RTOL``, ``ATOL``, or with ``max_rel`` within that share of their
    largest entry."""
    its, u, lam = ref

    def close(a, b):
        if max_rel is None:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        else:
            assert np.abs(a - b).max() <= max_rel * np.abs(b).max()

    assert len(res) == ranks
    for r in res:
        assert not r["jax_loaded"]
        assert r["converged"] and r["world_size"] == ranks
        assert r["iterations"] == its
        close(r["lam"], lam)
        assert r["counts"][moves] > 0
        assert r["counts"]["all_reduces"] > 0
    close(res[0]["u"], u)


@pytest.mark.parametrize("name", ["exact_w", "explicit", "explicit_exact_w",
                                  "band_on_boundary"])
def test_sharded_form_matches_jax(name, solved):
    """Equal outer count, u and λ within rtol 1e-9, atol 1e-11 of the JAX
    package's serial solve; the distributed levels of the expected
    kind."""
    res = solved["two"][name]
    check(res, solved["jax"][name], 2)
    assert res[0]["level_kinds"] == KINDS[name]
    if name == "band_on_boundary":        # one level: the fine is the coarsest
        assert res[0]["levels"] == 1
    if KINDS[name][0] == "k1":             # this rank's compact rows
        assert res[0]["compact_levels"] > 0


def test_sharded_bf16_matches_port_serial(solved):
    """The bf16 V-cycle on 2 ranks: the port's serial bf16 solve's outer
    count, and u and λ within rtol 1e-9, atol 1e-11 of it (read: 4.1e-14
    of max |u| apart; the bf16 bits of both cycles agree, the float32
    Lanczos bounds only to their sums' order)."""
    res = solved["two"]["bf16"]
    check(res, solved["bf16"], 2)
    assert res[0]["level_kinds"] == KINDS["bf16"]


def test_explicit_on_3_ranks_uneven_blocks(solved):
    res = solved["three"]
    rows = [r["rows"] for r in res]
    assert rows[0][0] == 0 and rows[-1][1] == 17
    assert len({hi - lo for lo, hi in rows}) > 1
    check(res, solved["jax"][UNEVEN], 3)


def test_jax_sharded_explicit_matches_port_on_4_ranks(solved):
    """The JAX package's ``build_sharded_solver(make_mesh(8))`` and the
    port's on 4 ranks, both in the explicit form."""
    check(solved["four"], solved["jax_sharded"], 4)


def _flagship_coupling(ref):
    space = GridSpace.q(UniformGrid.hyper_cube(2, 0.0, 1.0, ref), 1)

    def conf(p):
        s = p[:, 0]
        return np.stack([0.2 * np.cos(2 * np.pi * s) + 0.4,
                         0.2 * np.sin(2 * np.pi * s) + 0.4], axis=1)

    curve = parametrized_curve(conf, ref)
    return space, build_coupling(space, curve.space(1), 3, device="cpu"), \
        10.0 / curve.h_max


@pytest.mark.parametrize("explicit", [False, True])
def test_compact_rows_assemble_the_block(explicit):
    """Each of 3 row blocks' rows of the compact AL block (particle form,
    and explicit with w = diag(M)⁻²-like weights): ``m_own x m`` entries,
    the rows adding up to m; the ranks' shares sum to the band, and the
    rows applied to it are the whole block's apply on those rows; the
    diagonal is the whole block's."""
    space, C, gamma = _flagship_coupling(5)
    w = (np.random.default_rng(2).uniform(1.0, 2.0, C.shape[0])
         if explicit else None)
    al, diag = C.compact_al(gamma, w)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        space.n_dofs))
    whole = al(x)
    nx = space.n_points_1d[0]
    blocks = row_partition(space.n_points_1d[1], nx, 3)
    parts = [C.compact_al_rows(gamma, lo * nx, hi * nx, w)
             for lo, hi in map(blocks.rows, range(3))]
    assert sum(p.A.shape[0] for p in parts) == al.rows
    assert all(p.A.shape[1] == al.rows for p in parts)
    band = sum(p.share(x[p.first:p.last]) for p in parts)
    for p in parts:
        np.testing.assert_allclose(p.diag, diag, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(p.apply(band).numpy(),
                                   whole[p.first:p.last].numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, BF16])
def test_clipped_patch_on_extended_blocks(dtype):
    """K2 on an extended block (``AugmentedStencil2D.row_block``: the
    block's rows and the halo of its mode, the patch box clipped to the
    block's interior rows) equals the whole lattice's on the block's own
    rows bit for bit, in float64 and in bf16 (the bf16 V-cycle's level on a
    rank: bf16 planes and vectors)."""
    space, C, gamma = _flagship_coupling(5)
    box, w9 = C.patch_w9(space, gamma)
    planes = torch.as_tensor(np.stack([w9[a, b] for a, b in _PLANES]))
    ny, nx = space.n_points_1d[1], space.n_points_1d[0]
    h = (1.0 / (ny - 1), 1.0 / (nx - 1))
    st = AugmentedStencil2D(h, (ny, nx), planes.to(dtype), box)
    rng = np.random.default_rng(6)
    x, x0 = (torch.as_tensor(rng.standard_normal((ny, nx))).to(dtype)
             for _ in range(2))
    kw = dict(lam_max=1.5, degree=4)
    for mode, depth in (("op", HALO["op"]), ("pre", sweep_halo(4)),
                        ("post", sweep_halo(4))):
        def apply(s, lo, hi):
            out = fused_augmented_2d(mode, s, x[lo:hi],
                                     x0[lo:hi] if mode == "post" else None,
                                     **kw)
            return torch.stack(out) if mode == "pre" else out[None]

        whole = apply(st, 0, ny)
        for lo, hi in ((0, 9), (9, 17), (17, 33), (12, 13), (4, 30)):
            a, b = max(lo - depth, 0), min(hi + depth, ny)
            got = apply(st.row_block(a, b), a, b)[:, lo - a:hi - a]
            assert got.dtype == dtype
            assert torch.equal(got, whole[:, lo:hi]), (mode, lo, hi)
