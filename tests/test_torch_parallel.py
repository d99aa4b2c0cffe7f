"""The port's lattice padding, row-block partition, halo depths and sharded
steps (``parallel/lattice.py``, ``parallel/mesh.py``) against the JAX
package's ``parallel`` modules, in float64 on the CPU.

The sharded steps run on 1, 2 and 3 gloo ranks (``parallel.mesh.launch``,
spawned processes) against the JAX steps on the 8-device virtual mesh of
``tests/conftest.py``, at the JAX tests' tolerances.  JAX is imported inside
the tests only: a spawned rank imports this module to find its function,
and asserts that ``jax`` is not loaded."""

import sys

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_torch.core import (
    GridSpace, UniformGrid, parametrized_curve)
from fictitious_domain_al_preconditioners_torch.ops import kernels as K
from fictitious_domain_al_preconditioners_torch.ops.coupling import \
    build_coupling
from fictitious_domain_al_preconditioners_torch.parallel import (
    LatticeOps, launch, padded_shape, sharded_al_cg_step,
    sharded_two_level_step, to_flat, to_lattice)
from fictitious_domain_al_preconditioners_torch.parallel.mesh import (
    HALO, Mesh, plan_levels, row_partition, sweep_halo)

torch.set_num_threads(1)

GAMMA = 10.0


def circle_conf(pts):
    s = pts[:, 0]
    return np.stack([0.2 * np.cos(2 * np.pi * s) + 0.4,
                     0.2 * np.sin(2 * np.pi * s) + 0.4], axis=1)


def _space(dim, refinement):
    return GridSpace.q(UniformGrid.hyper_cube(dim, 0.0, 1.0, refinement), 1)


# -- LatticeOps against the JAX package (TestLatticeOps's cases) -----------

@pytest.mark.parametrize("dim", [1, 2, 3])
def test_lattice_ops_match_jax(dim):
    from fictitious_domain_al_preconditioners_tpu.core import (
        GridSpace as JSpace, UniformGrid as JGrid)
    from fictitious_domain_al_preconditioners_tpu.parallel import (
        LatticeOps as JLat, to_flat as j_flat, to_lattice as j_lattice)

    ref = 3 if dim < 3 else 2
    jsp = JSpace.q(JGrid.hyper_cube(dim, 0.0, 1.0, refinement=ref), 1)
    sp = _space(dim, ref)
    u = np.random.default_rng(0).standard_normal(sp.n_dofs)
    jl, tl = JLat.for_space(jsp), LatticeOps.for_space(sp)
    assert tl.dof_shape == tuple(jl.dof_shape) and tl.shape == jl.shape
    ju, tu = j_lattice(jsp, u), to_lattice(sp, torch.as_tensor(u))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    for name in ("laplace", "mass"):
        np.testing.assert_allclose(
            to_flat(getattr(tl, name)(tu)).numpy(),
            np.asarray(j_flat(getattr(jl, name)(ju))), rtol=0, atol=1e-12)


def test_lattice_ops_anisotropic_grid_match_jax():
    from fictitious_domain_al_preconditioners_tpu.core import (
        GridSpace as JSpace, UniformGrid as JGrid)
    from fictitious_domain_al_preconditioners_tpu.parallel import (
        LatticeOps as JLat, to_lattice as j_lattice)

    jsp = JSpace.q(JGrid(2, (0.0, 0.0), (2.0, 1.0), (8, 4)), 1)
    sp = GridSpace.q(UniformGrid(2, (0.0, 0.0), (2.0, 1.0), (8, 4)), 1)
    u = np.random.default_rng(1).standard_normal(sp.n_dofs)
    got = LatticeOps.for_space(sp).laplace(to_lattice(sp, torch.as_tensor(u)))
    ref = JLat.for_space(jsp).laplace(j_lattice(jsp, u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-11)


def test_roundtrip():
    sp = _space(3, 2)
    u = torch.arange(sp.n_dofs, dtype=torch.float64)
    assert torch.equal(to_flat(to_lattice(sp, u)), u)


@pytest.mark.parametrize("size", [2, 3, 8])
def test_padded_lattice_matches_jax(size):
    """``pad``/``unpad`` and the applies on a padded lattice, the pad kept
    zero, against the JAX package's ``padded`` LatticeOps (its padding for
    8 devices rounds both axes; the port's rounds the rows)."""
    from fictitious_domain_al_preconditioners_tpu.core import (
        GridSpace as JSpace, UniformGrid as JGrid)
    from fictitious_domain_al_preconditioners_tpu.parallel import (
        LatticeOps as JLat)

    sp = _space(2, 4)
    jsp = JSpace.q(JGrid.hyper_cube(2, 0.0, 1.0, 4), 1)
    pshape = padded_shape(sp.n_points_1d, Mesh(0, size, None,
                                               torch.device("cpu")))
    assert pshape[0] == sp.n_points_1d[0] and pshape[1] % size == 0
    assert pshape[1] - sp.n_points_1d[1] < size
    tl = LatticeOps.for_space(sp, padded=pshape)
    jl = JLat.for_space(jsp, padded=pshape)
    u = np.random.default_rng(2).standard_normal(tl.shape)
    tu, ju = tl.pad(torch.as_tensor(u)), jl.pad(u)
    assert tuple(tu.shape) == tuple(reversed(pshape))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tl.unpad(tu).numpy(), u)
    for name in ("laplace", "mass"):
        got, ref = getattr(tl, name)(tu), getattr(jl, name)(ju)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12)
        assert not got[tl.shape[0]:].any()


# -- the partition rule --------------------------------------------------------

@pytest.mark.parametrize("ny,size,align", [(33, 2, 0), (33, 3, 2), (17, 4, 1),
                                           (4097, 2, 8), (4097, 3, 9)])
def test_row_partition_nests(ny, size, align):
    """Blocks cover the rows once, near-evenly; ``align`` coarsenings keep
    whole nested blocks (coarse row i goes with fine row 2i)."""
    blocks = row_partition(ny, ny, size, align)
    assert blocks.starts[0] == 0 and blocks.ny == ny
    assert sum(blocks.counts) == ny and min(blocks.counts) > 0
    assert all(s % 2 ** align == 0 for s in blocks.starts[:-1])
    for _ in range(align):
        coarse = blocks.coarse()
        assert coarse.ny == (blocks.ny - 1) // 2 + 1
        assert coarse.nx == (blocks.nx - 1) // 2 + 1
        for r in range(size):
            lo, hi = blocks.rows(r)
            clo, chi = coarse.rows(r)
            assert (clo, chi) == (lo // 2, hi // 2 if r < size - 1
                                  else coarse.ny)
        blocks = coarse


def test_plan_levels():
    depth = sweep_halo(4)
    assert depth == 5 and HALO == {"laplace": 1, "op": 2, "transfer": 1}
    # refinement 12 over 2 ranks: 11 levels, 4097 ... 17 rows distributed
    levels = plan_levels(4097, 4097, 2, n_levels=11, depth=depth)
    assert [b.ny for b in levels] == [2 ** (12 - i) + 1 for i in range(9)]
    assert min(levels[-1].counts) >= depth
    assert min(levels[-1].coarse().counts) < depth   # the tail starts there
    # one rank distributes every level before the coarsest
    assert len(plan_levels(33, 33, 1, n_levels=4, depth=depth)) == 3
    # a one-level hierarchy's only level is distributed
    (fine,) = plan_levels(9, 9, 2, n_levels=1, depth=depth)
    assert fine.counts == [4, 5]
    # refinement 5 over 4 ranks: the fine level alone (blocks of 8, 8, 9, 8)
    (fine,) = plan_levels(33, 33, 4, n_levels=4, depth=depth)
    assert fine.counts == [8, 8, 9, 8]
    # refinement 4 over 4 ranks: blocks thinner than the halo (several
    # blocks give it)
    (fine,) = plan_levels(17, 17, 4, n_levels=3, depth=depth)
    assert fine.counts == [4, 4, 5, 4]
    with pytest.raises(ValueError, match="do not divide"):
        plan_levels(3, 3, 4, n_levels=1, depth=depth)

# -- halo depth of each kernel's plain version --------------------------------

NY, NX = 41, 23
BOX = (10, 4, 20, 15)
KW = dict(lam_max=2.0, degree=4, eig_ratio=30.0)
# (rows of a block): in the middle, one row, at the bottom and top edges,
# and one whose edge cuts the patch box (rows 10 .. 29)
BLOCKS = [(12, 25), (15, 16), (0, 14), (30, 41), (20, 34)]


def _stencil(patched):
    rng = np.random.default_rng(3)
    h = (1.0 / (NY - 1), 1.0 / (NX - 1))
    if not patched:
        return K.AugmentedStencil2D(h, (NY, NX), device="cpu",
                                    dtype=torch.float64)
    planes = torch.as_tensor(rng.standard_normal((5,) + tuple(BOX[2:]))) / 10
    planes[0] = planes[0].abs() + 1.0
    return K.AugmentedStencil2D(h, (NY, NX), planes, BOX)


def _apply(kind, st, x, x0, mode_out=0):
    if kind == "k6":
        return K.laplace_stencil_2d(x, st.h)
    if kind == "k1":
        return K.masked_laplace_2d(x, st.h)
    out = K.fused_augmented_2d(kind, st, x, x0 if kind == "post" else None,
                               **KW)
    return out[mode_out] if kind == "pre" else out


# the depth each call needs: K6 and K1/op from HALO, a sweep's x (smooth,
# pre's x) one row less than sweep_halo, pre's residual and post sweep_halo
DEPTHS = {("k6", 0): HALO["laplace"], ("k1", 0): HALO["op"],
          ("op", 0): HALO["op"], ("smooth", 0): sweep_halo(4) - 1,
          ("pre", 0): sweep_halo(4) - 1, ("pre", 1): sweep_halo(4),
          ("post", 0): sweep_halo(4)}


@pytest.mark.parametrize("kind,out,patched", [
    (k, o, p) for (k, o) in DEPTHS for p in (True, False)
    if p or k not in ("k6", "k1")])
def test_halo_depth_on_row_blocks(kind, out, patched):
    """Each kernel's plain version on an extended block (the block's rows
    plus ``depth`` rows either side, ``AugmentedStencil2D.row_block``, the
    patch box clipped) equals the whole lattice's rows bit for bit at its
    depth, and differs one row short of it where the block has a
    neighbour.  K2 with and without patch; K6 and K1 take none."""
    rng = np.random.default_rng(4)
    st = _stencil(patched)
    x = torch.as_tensor(rng.standard_normal((NY, NX)))
    x0 = torch.as_tensor(rng.standard_normal((NY, NX)))
    whole = _apply(kind, st, x, x0, out)
    depth = DEPTHS[(kind, out)]
    for lo, hi in BLOCKS:
        for d in (depth, depth - 1):
            a, b = max(lo - d, 0), min(hi + d, NY)
            blk = st.row_block(a, b)
            assert blk.shape == (b - a, NX)
            got = _apply(kind, blk, x[a:b], x0[a:b], out)[lo - a:hi - a]
            if d == depth:
                assert torch.equal(got, whole[lo:hi]), (lo, hi)
            else:
                assert (got - whole[lo:hi]).abs().max() > 1e-6, (lo, hi)


def test_row_block_clips_patch_box():
    st = _stencil(True)
    r0, c0, pr, pc = BOX
    inner = st.row_block(20, 34)          # rows 21 .. 29 of the box are kept
    assert inner.box == (1, c0, 9, pc)
    assert torch.equal(inner.planes, st.planes[:, 11:20])
    assert st.row_block(0, 11).patched is False   # the box starts at row 10
    assert st.row_block(9, 31).box == (1, c0, pr, pc)
    assert not st.row_block(30, 41).patched


# -- the sharded steps against the JAX package's --------------------------

def _steps_rank(mesh):
    """One rank of both sharded steps at the JAX tests' sizes: the AL CG
    step at refinement 4 (8 iterations, padded lattice), the two-level PCG
    at refinement 5 (4 iterations)."""
    assert "jax" not in sys.modules
    sp = _space(2, 4)
    curve = parametrized_curve(circle_conf, refinement=4)
    C = build_coupling(sp, curve.space(1), 3, device="cpu")
    lat = LatticeOps.for_space(sp, padded=padded_shape(sp.n_points_1d, mesh))
    b = np.random.default_rng(0).standard_normal(sp.n_points_1d)
    x_al = sharded_al_cg_step(mesh, lat, C, GAMMA, n_cg=8)(
        lat.pad(torch.as_tensor(b)))
    fine = _space(2, 5)
    b2 = np.random.default_rng(0).standard_normal(
        tuple(reversed(fine.n_points_1d)))
    x_tl = sharded_two_level_step(
        mesh, LatticeOps.for_space(fine),
        LatticeOps.for_space(fine.coarse_space()), n_cg=4,
        jacobi_diag=1.0 / (8.0 / 3.0))(torch.as_tensor(b2))
    return dict(al=lat.unpad(x_al).numpy(), two_level=x_tl.numpy(),
                padded=tuple(x_al.shape), counts=dict(mesh.counts),
                jax_loaded="jax" in sys.modules)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's sharded AL CG step (refinement 4, 8 devices) and
    two-level step (refinement 5) on the inputs of ``_steps_rank``."""
    import jax
    import jax.numpy as jnp

    from fictitious_domain_al_preconditioners_tpu.core import (
        GridSpace as JSpace, UniformGrid as JGrid,
        parametrized_curve as j_curve)
    from fictitious_domain_al_preconditioners_tpu.ops import \
        build_coupling as j_coupling
    from fictitious_domain_al_preconditioners_tpu.parallel import (
        LatticeOps as JLat, lattice_sharding, make_mesh,
        padded_shape as j_padded, sharded_al_cg_step as j_al,
        sharded_two_level_step as j_two)

    mesh = make_mesh(8)
    sp = JSpace.q(JGrid.hyper_cube(2, 0.0, 1.0, 4), 1)
    lat = JLat.for_space(sp, padded=j_padded(sp.n_points_1d, mesh))
    C = j_coupling(sp, j_curve(circle_conf, refinement=4).space(1), 3)
    shard = lattice_sharding(mesh)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(sp.n_points_1d))
    x = jax.jit(j_al(mesh, lat, C, GAMMA, n_cg=8), in_shardings=shard,
                out_shardings=shard)(jax.device_put(lat.pad(b), shard))
    fine = JSpace.q(JGrid.hyper_cube(2, 0.0, 1.0, 5), 1)
    b2 = jnp.asarray(np.random.default_rng(0).standard_normal(
        tuple(reversed(fine.n_points_1d))))
    x2 = jax.jit(j_two(mesh, JLat.for_space(fine),
                       JLat.for_space(fine.coarse_space()), n_cg=4,
                       jacobi_diag=1.0 / (8.0 / 3.0)))(b2)
    return np.asarray(lat.unpad(x)), np.asarray(x2)


@pytest.mark.parametrize("ranks", [1, 2, 3])
def test_sharded_steps_match_jax(ranks, jax_steps):
    x_al, x_tl = jax_steps
    results = launch(_steps_rank, ranks, backend="gloo", device="cpu",
                     timeout=300)
    for r, res in enumerate(results):
        assert not res["jax_loaded"]
        assert res["padded"] == (17 + (-17) % ranks, 17)
        np.testing.assert_allclose(res["al"], x_al, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(res["two_level"], x_tl, rtol=1e-10,
                                   atol=1e-10)
        if ranks > 1:
            assert res["counts"]["halo_exchanges"] > 0
            assert res["counts"]["all_reduces"] > 0
