"""The sharded augmented solve of the PyTorch port
(``ImmersedLaplaceProblem.build_sharded_solver``) on the element form: a
degree-2 background, Dirichlet conditions on two sides only, and the
shipped ``flower_f1_g1.prm``, ``square_f1_g1.prm`` and ``circle_f0_g1.prm``
(background 5 + 1 local step near Γ, Γ at 6, the exact W = M), and the
flower in both explicit forms (W = diag(M)², W = M²) and with the bf16
V-cycle, each level's flat dof vector cut into contiguous ranges, on 2 gloo
ranks (the flower also on 3), in float64 on the CPU with the JAX package's
setup state and Lanczos vectors carried, held to the JAX package solving in
the test (the bf16 V-cycle to the port's serial bf16 solve); the JAX
package's own sharded solver on its 8-device virtual mesh against the port
on 4 ranks for the flower; and the row forms of the element-form matrix,
the transfers and the range plan.

The ranks run while the JAX package solves (they need only its setup
state), so the file takes about the time of the slower of the two."""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models.immersed_laplace import \
    ImmersedLaplaceProblem as JProblem
from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceConfig as TConfig, ImmersedLaplaceProblem as TProblem)
from fictitious_domain_al_preconditioners_torch.ops.assembly import \
    laplace_matrix
from fictitious_domain_al_preconditioners_torch.ops.operators import CellRows
from fictitious_domain_al_preconditioners_torch.parallel import launch
from fictitious_domain_al_preconditioners_torch.parallel.dryrun import (
    flagship_config, sharded_flagship_rank, sharded_runs_rank)
from fictitious_domain_al_preconditioners_torch.parallel.mesh import (
    FLAT_MIN_ROWS, plan_ranges, range_partition)
from fictitious_domain_al_preconditioners_torch.precond.gmg import (
    ProlongationRows, level_spaces, make_prolongation)
from fictitious_domain_al_preconditioners_torch.utils.carry import (
    gmg_level_sizes, state_from_jax)
from test_torch_sharded_forms import ATOL, RTOL, check, jax_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = ("flower/flower_f1_g1", "square/square_f1_g1",
           "circle/circle_f0_g1")


def _uniform(ref, **kw):
    cfg = flagship_config(ref)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _shipped(name, **kw):
    return dataclasses.replace(TConfig.from_prm(os.path.join(
        ROOT, "parameters", name + ".prm")), **kw)


FLOWER = "flower_f1_g1"
BF16 = "flower_bf16"
CONFIGS = {"degree_2": _uniform(4, embedding_space_degree=2),
           "partial_dirichlet": _uniform(4, dirichlet_ids=(0, 1)),
           **{name.split("/")[1]: _shipped(name) for name in SHIPPED},
           # the flower in both explicit forms, W = diag(M)² and W = M²
           "flower_explicit": _shipped(SHIPPED[0], use_operator_form=False),
           "flower_explicit_exact_w": _shipped(
               SHIPPED[0], use_operator_form=False,
               use_diagonal_inverse=False),
           BF16: _shipped(SHIPPED[0], use_bf16_multigrid=True)}
# u and λ of the sharded bf16 V-cycle from the serial one, relative to
# their largest entry (test_sharded_flower_bf16_matches_port_serial)
BF16_TOL = 1e-6
# distributed levels on 2 ranks (plan_ranges): the tree's levels of 1,394
# (the flower), 1,089 and 289 dofs, the Q2 lattice's 1,089 and 289, the
# partial Dirichlet Q1 lattice's 289
DISTRIBUTED = {"degree_2": 2, "partial_dirichlet": 1, "flower_f1_g1": 3,
               "square_f1_g1": 3, "circle_f0_g1": 3, "flower_explicit": 3,
               "flower_explicit_exact_w": 3, BF16: 3}


def element_arrays(jp, cfg):
    """The JAX problem's setup state for ``state_from_jax``: the right-hand
    sides, Dirichlet data, the coupling table (its folded tabulation on a
    tree), the immersed mass and stiffness matrices, and the Lanczos start
    vector ``jax.random.normal(PRNGKey(0), (n,))`` of every level of the
    port's flat hierarchy."""
    C = jp.C
    sizes = gmg_level_sizes(TProblem(cfg, device="cpu").setup().space)
    return dict(
        rhs_f=np.asarray(jp.rhs_f), rhs_g=np.asarray(jp.rhs_g),
        bc_values=np.asarray(jp.bc_values), free=np.asarray(jp.free),
        bg_dofs=np.asarray(C.bg_dofs), bg_phi=np.asarray(C.bg_phi),
        imm_dofs=np.asarray(C.imm_dofs), imm_psi=np.asarray(C.imm_psi),
        jxw=np.asarray(C.jxw), m_diag=np.asarray(jp.M.diag()),
        imm_cell_dofs=np.asarray(jp.M.row_dofs),
        m_local=np.asarray(jp.M.local), a_local=np.asarray(jp.A_imm.local),
        lanczos_starts=[np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (n,), dtype=jnp.float64)) for n in sizes])


def _ranks(pool, runs, flower):
    """The 2-rank runs, and the 3- and 4-rank runs of one configuration
    beside them."""
    two = pool.submit(launch, sharded_runs_rank, 2, backend="gloo",
                      device="cpu", args=(runs,), timeout=600)
    more = [launch(sharded_flagship_rank, n, backend="gloo", device="cpu",
                   args=flower, timeout=600) for n in (3, 4)]
    return two.result(), *more


@pytest.fixture(scope="module")
def solved():
    """Every configuration on 2 ranks, the flower on 3 and 4, the JAX
    package's serial solves and its sharded flower solve."""
    from fictitious_domain_al_preconditioners_tpu.parallel import \
        make_mesh as j_make_mesh

    jps = {k: JProblem(jax_config(c)).setup() for k, c in CONFIGS.items()}
    arrays = {k: element_arrays(jp, CONFIGS[k]) for k, jp in jps.items()}
    runs = [(CONFIGS[k], arrays[k]) for k in CONFIGS]
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(_ranks, pool, runs,
                            (CONFIGS[FLOWER], arrays[FLOWER]))
        jax_out = {}
        for k, jp in jps.items():
            if k != BF16:
                u, lam, info = jp.solve()
                jax_out[k] = (int(info.iterations), np.asarray(u),
                              np.asarray(lam))
        jp = jps[FLOWER]
        u, lam, info = jp.build_sharded_solver(j_make_mesh(8))(
            jp.rhs_f, jp.rhs_g, jp.bc_values)
        jax_sharded = (int(info.iterations), np.asarray(u), np.asarray(lam))
        tp = TProblem(CONFIGS[BF16], device="cpu").setup()
        tp.load_state(state_from_jax(arrays[BF16], "cpu", torch.float64))
        u, lam, info = tp.solve()
        bf16 = (info.iterations, u.numpy(), lam.numpy())
        two, three, four = ranks.result()
    return dict(two=dict(zip(CONFIGS, zip(*two))), three=three, four=four,
                jax=jax_out, jax_sharded=jax_sharded, bf16=bf16)


@pytest.mark.parametrize("name", sorted(set(CONFIGS) - {BF16}))
def test_sharded_element_form_matches_jax(name, solved):
    """Equal outer count, u and λ within rtol 1e-9, atol 1e-11 of the JAX
    package's serial solve; every distributed level in element form (no
    kernel)."""
    res = solved["two"][name]
    check(res, solved["jax"][name], 2, moves="all_gathers")
    r0 = res[0]
    assert r0["level_kinds"] == ["element"] * DISTRIBUTED[name]
    assert r0["launches"] == {}


def test_sharded_flower_bf16_matches_port_serial(solved):
    """The flower with the bf16 V-cycle on 2 ranks (bf16 level operators,
    smoother, transfers and all-gathers): the port's serial bf16 solve's
    outer count, and u and λ within ``BF16_TOL`` of their largest entry.
    Read: 4.6e-10 (u) and 4.7e-8 (λ).  The distributed levels' float32
    Lanczos sums run in another order, and through the bf16 level operator
    their bounds move by about 1e-5 (on 3 ranks 3.4e-12 and 1.8e-10)."""
    res = solved["two"][BF16]
    check(res, solved["bf16"], 2, moves="all_gathers", max_rel=BF16_TOL)
    assert res[0]["level_kinds"] == ["element"] * DISTRIBUTED[BF16]
    assert res[0]["launches"] == {}


def test_flower_on_3_ranks(solved):
    res = solved["three"]
    rows = [r["rows"] for r in res]
    assert rows[0][0] == 0 and all(a[1] == b[0] for a, b in zip(rows,
                                                                rows[1:]))
    check(res, solved["jax"][FLOWER], 3, moves="all_gathers")


def test_jax_sharded_flower_matches_port_on_4_ranks(solved):
    """The JAX package's ``build_sharded_solver(make_mesh(8))`` on the
    shipped flower and the port's on 4 ranks."""
    check(solved["four"], solved["jax_sharded"], 4, moves="all_gathers")


def _flower_space():
    return TProblem(CONFIGS[FLOWER], device="cpu").setup().space


def test_cell_matrix_row_block():
    """``CellRows``: rows ``[first, last)`` of the tree's stiffness (a ``CellMatrixSum``
    with shared and folded per-cell parts) and of a shared-local Q2
    matrix: ``mv`` of the whole vector gives those rows of ``A x``."""
    from fictitious_domain_al_preconditioners_torch.core import (
        GridSpace, UniformGrid)

    rng = np.random.default_rng(8)
    for space in (_flower_space(),
                  GridSpace.q(UniformGrid.hyper_cube(2, 0.0, 1.0, 3), 2)):
        K = laplace_matrix(space, order=3, device="cpu",
                           dtype=torch.float64)
        x = torch.as_tensor(rng.standard_normal(space.n_dofs))
        whole = K.mv(x)
        blocks = range_partition(space.n_dofs, 3)
        for r in range(3):
            lo, hi = blocks.rows(r)
            np.testing.assert_allclose(CellRows(K, lo, hi).mv(x).numpy(),
                                       whole[lo:hi].numpy(), rtol=1e-13,
                                       atol=1e-13)


def test_prolongation_rows():
    """A rank's fine rows of ``P xc`` and coarse rows of ``Pᵀ xf`` on the
    tree's transfers (the folded basis) equal the whole transfer's."""
    spaces = level_spaces(_flower_space())
    rng = np.random.default_rng(9)
    for fine, coarse in zip(spaces, spaces[1:]):
        P = make_prolongation(fine, coarse, device="cpu")
        xc = torch.as_tensor(rng.standard_normal(coarse.n_dofs))
        xf = torch.as_tensor(rng.standard_normal(fine.n_dofs))
        fb, cb = (range_partition(n, 3) for n in (fine.n_dofs,
                                                  coarse.n_dofs))
        for r in range(3):
            lo, hi = fb.rows(r)
            np.testing.assert_allclose(ProlongationRows(P, lo, hi).mv(xc),
                                       P.mv(xc)[lo:hi], rtol=1e-14,
                                       atol=1e-14)
            lo, hi = cb.rows(r)
            np.testing.assert_allclose(
                ProlongationRows(P, lo, hi, restrict=True).rmv(xf),
                P.rmv(xf)[lo:hi], rtol=1e-13, atol=1e-13)


def test_plan_ranges():
    """The fine level is always distributed (one level too), a coarser
    one while every range holds ``FLAT_MIN_ROWS`` entries, the coarsest
    never; the ranges cover each level once."""
    sizes = gmg_level_sizes(_flower_space())
    assert FLAT_MIN_ROWS == 128
    plan = plan_ranges(sizes, 2)
    assert len(plan) == sum(n // 2 >= FLAT_MIN_ROWS for n in sizes[:-1])
    assert len(plan) >= 2 and len(plan) < len(sizes)
    for blocks, n in zip(plan, sizes):
        assert blocks.starts[0] == 0 and blocks.ny == n and blocks.nx == 1
        assert min(blocks.counts) > 0 and sum(blocks.counts) == n
    assert sizes == [1394, 1089, 289, 81, 25]
    assert len(plan) == 3 and len(plan_ranges(sizes, 8)) == 2
    assert len(plan_ranges([25], 2)) == 1
    with pytest.raises(ValueError, match="do not divide"):
        range_partition(3, 4)
