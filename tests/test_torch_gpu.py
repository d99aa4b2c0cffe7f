"""The port's CUDA kernels on the card: each wrapper against its plain
version (K1 in float32 and bf16; K1, K6 in float32 and float64 and the
patched K2 ``op`` at the edge shapes of the register window they share), the
wrappers' checks, and small solves of every mode, of the flagship with the
bf16 V-cycle and of the elliptic interface problem against the CPU, the
elliptic path's band stencil and lattice mass inverse against the CPU, and
its dense float32 A22 inverse against TF32; the Stokes problem at 4:5
against the CPU, and its velocity hierarchy's level operators (the vector
band stencil, the element form) and V-cycle against the CPU; the exact-W
and explicit AL forms of the augmented solver, the nitsche problem and the
3D elasticity problem against the CPU; immersed_laplace and Stokes with local
refinement near Γ (the element-form path) against the CPU.
Marked ``gpu``; without a card every test skips.  On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py -q
"""

import functools
import os
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as S
from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceConfig, ImmersedLaplaceProblem)
from fictitious_domain_al_preconditioners_torch.ops import kernels as K

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _stencil(device, shape=(97, 161), box=(20, 30, 40, 50), seed=0):
    rng = np.random.default_rng(seed)
    planes = rng.uniform(0.1, 1.0, (5,) + box[2:]).astype(np.float32)
    h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    return K.AugmentedStencil2D(h, shape, torch.as_tensor(planes,
                                                          device=device), box)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("box", [(20, 30, 40, 50), (0, 0, 97, 161)])
def test_kernels_match_plain(cuda, box):
    st = _stencil(cuda, box=box)
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                        device=cuda)
    x0 = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                         device=cuda)
    before = dict(K.LAUNCHES)
    assert _rel(K.masked_laplace_2d(b, st.h),
                K.masked_laplace_2d_plain(b, st.h)) <= 1e-6
    tol = {"op": 1e-6, "smooth": 2e-5, "pre": 2e-5, "post": 5e-5}
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        got = K.fused_augmented_2d(mode, st, b, xin, lam_max=1.5)
        ref = K.fused_augmented_2d_plain(mode, st, b, xin, lam_max=1.5)
        if mode == "pre":
            assert _rel(got[0], ref[0]) <= tol[mode]
            assert _rel(got[1], ref[1]) <= 5e-5
        else:
            assert _rel(got, ref) <= tol[mode]
    assert K.LAUNCHES["masked_laplace_2d"] == before["masked_laplace_2d"] + 1
    for mode in K.MODES:
        key = f"fused_augmented_2d:{mode}"
        assert K.LAUNCHES[key] == before[key] + 1


@pytest.mark.parametrize("shape", [(97, 161), (1025, 1025)])
def test_k6_and_no_patch_k2_match_plain(cuda, shape):
    h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    st = K.AugmentedStencil2D(h, shape, device=cuda, dtype=torch.float32)
    rng = np.random.default_rng(2)
    b = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    x0 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=cuda)
    before = dict(K.LAUNCHES)
    assert _rel(K.laplace_stencil_2d(b, h),
                K.laplace_stencil_2d_plain(b, h)) <= 1e-6
    tol = {"op": 1e-6, "smooth": 2e-5, "pre": 2e-5, "post": 5e-5}
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        got = K.fused_augmented_2d(mode, st, b, xin, lam_max=1.5)
        ref = K.fused_augmented_2d_plain(mode, st, b, xin, lam_max=1.5)
        pairs = zip(got, ref) if mode == "pre" else [(got, ref)]
        for g, r in pairs:
            assert _rel(g, r) <= tol[mode]
    assert K.LAUNCHES["laplace_stencil_2d"] == \
        before["laplace_stencil_2d"] + 1
    for mode in K.MODES:
        key = K.launch_key(mode, patch=False)
        assert K.LAUNCHES[key] == before[key] + 1


def _edge_cases():
    """(lattice, box or None, degree) at the edges of K2's output tile (ty x
    tx at that degree): lattices one point either side of a multiple of it,
    boxes whose origin and far corner sit on tile edges, boxes touching the
    lattice border, the coarse levels 5², 9², 17², and degrees 2 and 6."""
    cases = []
    for deg in (2, 4, 6):
        ty, tx = K.sweep_output_tile("pre", deg)
        for d in (-1, 1):
            shape = (4 * ty + d, 3 * tx - d)
            cases += [(shape, None, deg),
                      (shape, (ty, tx, 2 * ty, tx), deg),
                      (shape, (0, 0, 3 * ty, tx), deg),
                      (shape, (ty, 1, shape[0] - ty, shape[1] - 1), deg)]
    for n in (5, 9, 17):
        cases += [((n, n), None, 4), ((n, n), (0, 0, n, n), 4),
                  ((n, n), (1, 2, n - 2, n - 3), 2)]
    return cases


@pytest.mark.parametrize("shape,box,degree", _edge_cases())
def test_sweeps_at_tile_edges(cuda, shape, box, degree):
    """K2 ``pre`` and ``post`` against the plain version at ``chip_smoke.py``'s
    tolerances (relative 2e-5 and 5e-5: the Chebyshev recurrence in float32
    in another order), on the shapes where the tile's halo and the patch
    box's edges meet."""
    if box is None:
        h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
        st = K.AugmentedStencil2D(h, shape, device=cuda, dtype=torch.float32)
    else:
        st = _stencil(cuda, shape, box, seed=sum(box))
    rng = np.random.default_rng(4)
    b = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    x0 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=cuda)
    kw = dict(lam_max=1.5, degree=degree)
    got = K.fused_augmented_2d("pre", st, b, **kw)
    ref = K.fused_augmented_2d_plain("pre", st, b, **kw)
    assert _rel(got[0], ref[0]) <= 2e-5 and _rel(got[1], ref[1]) <= 2e-5
    got = K.fused_augmented_2d("post", st, b, x0, **kw)
    ref = K.fused_augmented_2d_plain("post", st, b, x0, **kw)
    assert _rel(got, ref) <= 5e-5


_RCP_CHECK = r"""
#include <cstdio>
#include "fdal_sweep.cuh"
__global__ void check(unsigned long long* bad, unsigned lo, unsigned n) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(lo + i);
    if (__float_as_uint(fdal::rcp_rn(d)) != __float_as_uint(__frcp_rn(d)))
      atomicAdd(bad, 1ull);
  }
}
int main() {
  unsigned long long* bad;
  cudaMallocManaged(&bad, sizeof(*bad));
  *bad = 0;
  const unsigned lo = 0x3f800000u, hi = 0x4b800000u;  // [1, 2^24)
  check<<<1320, 256>>>(bad, lo, hi - lo);
  if (cudaDeviceSynchronize() != cudaSuccess) return 2;
  printf("%llu\n", *bad);
  return 0;
}
"""


def test_rcp_rn_is_the_ieee_reciprocal(cuda, tmp_path):
    """The patched sweeps form D⁻¹ = 1/(Kc + w_c) with ``rcp_rn`` (no slow
    path); it must be bit-equal to IEEE 1/d on every float in [1, 2²⁴), the
    range of Kc + w_c (Kc = 8/3 on square cells, w_c >= 0)."""
    src = tmp_path / "rcp_check.cu"
    src.write_text(_RCP_CHECK)
    exe = tmp_path / "rcp_check"
    subprocess.run([K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I",
                    os.path.dirname(K.HEADERS[0]), "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    res = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True)
    assert res.stdout.strip() == "0"


# K1's lattices: the coarse levels and the shapes of the other card tests;
# lattices shorter than one chunk of a thread's run, narrower than one warp,
# or without interior; rows of 30 k +- 1 points (a warp writes 30 columns);
# an even and an odd row length on each side of a multiple of the block's
# tile in each of the launch's three plans: 1 x 120 on small lattices, 4 x
# 120 on middle ones, and 8 x 120 (float32) or 16 x 120 (bf16) on large ones
# (``test_k1_tile_is_what_the_edge_shapes_assume`` holds these numbers to the
# library)
K1_SHAPES = [(5, 5), (9, 9), (17, 17), (65, 65), (97, 161), (530, 777),
             (1025, 1025),
             (1, 7), (2, 40), (3, 3), (5, 200), (7, 1300), (300, 3), (40, 2),
             (3, 50000), (50000, 3), (7, 700000),
             (17, 29), (17, 31), (33, 59), (33, 61), (9, 32),
             (63, 238), (63, 239), (64, 240), (65, 241), (65, 242),
             (511, 598), (511, 599), (512, 600), (513, 601), (513, 602),
             (2239, 2158), (2239, 2159), (2240, 2160), (2241, 2161),
             (2241, 2162)]


def test_k1_tile_is_what_the_edge_shapes_assume(cuda):
    tile = K.masked_laplace_tile
    assert tile(64, 240) == dict(chunk_rows=1, run_rows=1, tile_columns=120)
    assert tile(512, 600, bf16=True) == dict(chunk_rows=4, run_rows=4,
                                             tile_columns=120)
    assert tile(3, 50000) == tile(50000, 3) == tile(512, 600)
    assert tile(2240, 2160) == tile(7, 700000) == dict(
        chunk_rows=8, run_rows=8, tile_columns=120)
    assert tile(2239, 2158, bf16=True) == dict(chunk_rows=8, run_rows=16,
                                               tile_columns=120)
    for bf16 in (False, True):
        for chunk in K.K1_CHUNKS:
            res = K.masked_laplace_resources(bf16, chunk)
            assert res["threads"] == 128 and res["local_bytes"] == 0
            assert res["blocks_per_sm"] >= 8 and res["registers"] > 0
            assert res["static_smem_bytes"] == 0
    with pytest.raises(RuntimeError):
        K.masked_laplace_resources(False, 3)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_matches_plain_at_tile_edges(cuda, shape, bf16):
    """K1 against its plain version: float32 to 1e-6 of max |plain| (another
    float32 summation order), the bf16-storage form to one bf16 ulp of the
    largest value (8e-3: a float32 sum order can flip one rounding); the
    boundary rows and columns are the input bit for bit, and the input is
    left as it was."""
    h = (1.0 / max(shape[0] - 1, 1), 1.0 / max(shape[1] - 1, 1))
    u = torch.as_tensor(np.random.default_rng(sum(shape)).standard_normal(
        shape), dtype=torch.float32, device=cuda)
    if bf16:
        u = u.to(torch.bfloat16)
    kept = u.clone()
    key = "masked_laplace_2d:bf16" if bf16 else "masked_laplace_2d"
    before = K.LAUNCHES[key]
    got = K.masked_laplace_2d(u, h)
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] == before + 1
    assert got.dtype == u.dtype and tuple(got.shape) == shape
    assert got.data_ptr() != u.data_ptr()
    bits = torch.int16 if bf16 else torch.int32
    assert torch.equal(u.view(bits), kept.view(bits))
    ref = K.masked_laplace_2d_plain(u, h)
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got.float(), ref.float()) <= (8e-3 if bf16 else 1e-6)
    for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        assert torch.equal(got[edge].contiguous().view(bits),
                           u[edge].contiguous().view(bits))


def test_k1_is_the_no_patch_k2_op(cuda):
    """The no-patch K2 ``op`` kernel computes K1's function (its yardstick in
    ``chip_smoke.py``): the two kernels agree to float32 rounding."""
    shape = (530, 777)
    h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    st = K.AugmentedStencil2D(h, shape, device=cuda, dtype=torch.float32)
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(shape),
                        dtype=torch.float32, device=cuda)
    assert _rel(K.masked_laplace_2d(u, h),
                K.fused_augmented_2d("op", st, u)) <= 1e-6


@pytest.mark.parametrize("shape", [(65, 65), (1025, 1025), (530, 777)])
def test_k1_bf16_matches_plain(cuda, shape):
    """K1's bf16-storage form against its plain version (float32 arithmetic,
    one rounding): a float32 sum order can flip one bf16 rounding, one ulp
    (2^-8) of the value, so the bound is 1e-2 of max |plain|."""
    h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(shape),
                        dtype=torch.float32, device=cuda).to(torch.bfloat16)
    before = dict(K.LAUNCHES)
    got = K.masked_laplace_2d(u, h)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert _rel(got.float(), K.masked_laplace_2d_plain(u, h).float()) <= 1e-2
    assert K.LAUNCHES["masked_laplace_2d:bf16"] == \
        before["masked_laplace_2d:bf16"] + 1
    assert K.LAUNCHES["masked_laplace_2d"] == before["masked_laplace_2d"]


def test_window_plan_is_the_librarys(cuda):
    """The Python mirror of the window's plan, which places the edge shapes,
    against what K6 and the patched K2 ``op`` report; neither kernel spills
    or takes shared memory in any chunk."""
    for shape in ((64, 240), (362, 362), (363, 362), (512, 600), (3, 50000),
                  (2048, 2047), (2048, 2048), (2240, 2160), (4097, 4097)):
        plan = K.window_plan(*shape)
        assert K.laplace_stencil_tile(*shape) == plan
        assert K.augmented_op_tile(*shape) == dict(
            plan, patch_chunk_rows=min(plan["chunk_rows"], K.PATCH_CHUNK))
        assert K.masked_laplace_tile(*shape) == plan
    k6_f64 = functools.partial(K.laplace_stencil_resources, f64=True)
    for query in (K.laplace_stencil_resources, k6_f64,
                  K.augmented_op_resources):
        for chunk in K.K1_CHUNKS:
            res = query(chunk)
            assert res["threads"] == 128 and res["local_bytes"] == 0
            assert res["static_smem_bytes"] == 0 and res["registers"] > 0
            assert res["blocks_per_sm"] >= 6 and res["tile_columns"] == 120
        with pytest.raises(RuntimeError):
            query(3)
    res = K.fused_augmented_resources("op", patch=True)
    assert res["dynamic_smem_bytes"] == 0 and res["threads"] == 128
    assert K.fused_augmented_resources("op", patch=False)["threads"] == 384


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("shape", S.window_edge_shapes())
def test_k6_matches_plain_at_tile_edges(cuda, shape, dtype, tol):
    """K6 in both forms, float32 (the V-cycles') and float64 (the elliptic
    outer operator's and inner CGs'), against its plain version to 1e-6 and
    1e-13 of max |plain| (another summation order) where the lattice's edge
    rows and columns, with their boundary centres, meet the edges of a
    warp's columns and of a lane's run; each form counts under its own key
    and leaves the input as it was."""
    h = (1.0 / max(shape[0] - 1, 1), 1.0 / max(shape[1] - 1, 1))
    u = torch.as_tensor(np.random.default_rng(sum(shape)).standard_normal(
        shape), dtype=dtype, device=cuda)
    kept = u.clone()
    key = ("laplace_stencil_2d:f64" if dtype == torch.float64
           else "laplace_stencil_2d")
    before = dict(K.LAUNCHES)
    got = K.laplace_stencil_2d(u, h)
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] == before[key] + 1
    assert sum(K.LAUNCHES.values()) == sum(before.values()) + 1
    assert got.dtype == u.dtype and tuple(got.shape) == shape
    assert got.data_ptr() != u.data_ptr()
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(u.view(bits), kept.view(bits))
    assert bool(torch.isfinite(got).all())
    assert _rel(got, K.laplace_stencil_2d_plain(u, h)) <= tol


@pytest.mark.parametrize("shape,box", S.op_edge_cases())
def test_patched_op_matches_plain_at_tile_edges(cuda, shape, box):
    """The patched K2 ``op`` against its plain version to 1e-6 of max
    |plain| where the patch box's edges meet a warp's first and last kept
    column, a run's first and last row and the lattice's border; the
    boundary rows and columns are the input bit for bit, and the input is
    left as it was."""
    st = S.random_patch_stencil(shape, box, cuda, seed=sum(box))
    b = torch.as_tensor(np.random.default_rng(sum(shape)).standard_normal(
        shape), dtype=torch.float32, device=cuda)
    kept = b.clone()
    key = K.launch_key("op")
    before = dict(K.LAUNCHES)
    got = K.fused_augmented_2d("op", st, b)
    torch.cuda.synchronize()
    assert K.LAUNCHES[key] == before[key] + 1
    assert K.LAUNCHES[K.launch_key("op", False)] == \
        before[K.launch_key("op", False)]
    assert got.dtype == b.dtype and tuple(got.shape) == shape
    assert got.data_ptr() != b.data_ptr()
    assert torch.equal(b.view(torch.int32), kept.view(torch.int32))
    assert bool(torch.isfinite(got).all())
    assert _rel(got, K.fused_augmented_2d_plain("op", st, b)) <= 1e-6
    for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        assert torch.equal(got[edge].contiguous().view(torch.int32),
                           b[edge].contiguous().view(torch.int32))


def test_patched_op_without_planes_is_k1(cuda):
    """With planes of zeros the patched ``op`` kernel computes K1's function:
    the warps that meet the box run the patched walk, the others K1's."""
    shape, box = (530, 777), (100, 200, 300, 400)
    h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    st = K.AugmentedStencil2D(h, shape, torch.zeros(
        (5,) + box[2:], dtype=torch.float32, device=cuda), box)
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(shape),
                        dtype=torch.float32, device=cuda)
    assert _rel(K.fused_augmented_2d("op", st, u),
                K.masked_laplace_2d(u, h)) <= 1e-6


def test_wrappers_check_their_inputs(cuda):
    st = _stencil(cuda)
    with pytest.raises(TypeError):
        K.masked_laplace_2d(torch.zeros(st.shape, dtype=torch.float64,
                                        device=cuda), st.h)
    with pytest.raises(TypeError):
        K.masked_laplace_2d(torch.zeros(st.shape, dtype=torch.float16,
                                        device=cuda), st.h)
    with pytest.raises(TypeError):
        K.laplace_stencil_2d(torch.zeros(st.shape, dtype=torch.bfloat16,
                                         device=cuda), st.h)
    with pytest.raises(ValueError):
        K.fused_augmented_2d("op", st, torch.zeros((5, 5), device=cuda))
    with pytest.raises(ValueError):
        K.fused_augmented_2d("smooth", st, torch.zeros(st.shape,
                                                       device=cuda).T)


def test_small_flagship_matches_cpu(cuda):
    def cfg():
        c = ImmersedLaplaceConfig(
            initial_refinement=6, initial_embedded_refinement=6,
            embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                    "R=.2, Cx=.4, Cy=.4"),
            embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
            embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
            solver="augmented", use_operator_form=True,
            use_diagonal_inverse=True)
        c.schur.tolerance, c.schur.reduction = 3e-5, 1e-6
        return c

    ug, _, ig = ImmersedLaplaceProblem(cfg(), device=cuda).setup().solve()
    uc, _, ic = ImmersedLaplaceProblem(cfg(), device="cpu",
                                        dtype=torch.float32).setup().solve()
    assert ig.converged and abs(ig.iterations - ic.iterations) <= 1
    assert float((ug.cpu() - uc).abs().max()) <= 1e-3 * float(uc.abs().max())


def test_bf16_flagship_matches_cpu(cuda):
    """The flagship with the bf16 V-cycle at refinement 7, float32 outer:
    the card (K1 bf16 on every level) against the CPU (plain versions)."""
    def cfg():
        c = ImmersedLaplaceConfig(
            initial_refinement=7, initial_embedded_refinement=7,
            embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                    "R=.2, Cx=.4, Cy=.4"),
            embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
            embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
            solver="augmented", use_operator_form=True,
            use_diagonal_inverse=True, use_bf16_multigrid=True)
        c.schur.tolerance, c.schur.reduction = 3e-5, 1e-6
        return c

    K.reset_launch_counts()
    ug, _, ig = ImmersedLaplaceProblem(cfg(), device=cuda).setup().solve()
    launches = dict(K.LAUNCHES)
    uc, _, ic = ImmersedLaplaceProblem(cfg(), device="cpu",
                                        dtype=torch.float32).setup().solve()
    assert ig.converged and abs(ig.iterations - ic.iterations) <= 1
    assert float((ug.cpu() - uc).abs().max()) <= 1e-3 * float(uc.abs().max())
    assert launches["masked_laplace_2d:bf16"] > 0
    assert launches[K.launch_key("op")] > 0
    assert launches[K.launch_key("pre")] == 0


@pytest.mark.parametrize("solver", ["CG", "ELMAN_triang", "rational"])
def test_small_modes_match_cpu(cuda, solver):
    """The f = 0, g = 1 circle at refinement 5 with the flagship's float32
    stopping rule: the card (kernels) against the CPU (plain versions)."""
    def cfg():
        c = ImmersedLaplaceConfig(
            initial_refinement=5, initial_embedded_refinement=5,
            embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                    "R=.2, Cx=.4, Cy=.4"),
            solver=solver)
        c.schur.tolerance, c.schur.reduction = 3e-5, 1e-6
        return c

    K.reset_launch_counts()
    ug, _, ig = ImmersedLaplaceProblem(cfg(), device=cuda).setup().solve()
    launches = dict(K.LAUNCHES)
    uc, _, ic = ImmersedLaplaceProblem(cfg(), device="cpu",
                                       dtype=torch.float32).setup().solve()
    assert ig.converged and abs(ig.iterations - ic.iterations) <= 1
    assert float((ug.cpu() - uc).abs().max()) <= 1e-3 * float(uc.abs().max())
    for key in ("masked_laplace_2d", "laplace_stencil_2d",
                K.launch_key("pre", False), K.launch_key("post", False)):
        assert launches[key] > 0, key


@pytest.mark.parametrize("kw", [{}, dict(use_operator_form=True),
                                dict(use_modified_AL_preconditioner=False,
                                     gamma_AL_immersed=10.0,
                                     use_fixed_iterations=False)])
def test_small_elliptic_matches_cpu(cuda, kw):
    """The elliptic interface problem in chip_smoke.py's configuration at
    cycle 0 (33² + 9² dofs), float32 V-cycles and float64 operator and
    Krylov solvers: the card (K6 on every stiffness apply, float64 in the
    operator and the inner CGs, float32 in the V-cycles) against the CPU
    (plain versions)."""
    from fictitious_domain_al_preconditioners_torch.models import \
        EllipticInterfaceProblem

    def problem(device, **extra):
        cfg = S.elliptic_config()
        for k, v in kw.items():
            setattr(cfg, k, v)
        return EllipticInterfaceProblem(cfg, device=device, **extra).setup(0)

    K.reset_launch_counts()
    pg = problem(cuda)
    ig = pg.solve()
    launches = dict(K.LAUNCHES)
    pc = problem("cpu", dtype=torch.float32)
    ic = pc.solve()
    assert pg.results["converged"] and abs(ig - ic) <= 1
    xg = torch.cat([pg.u, pg.u2, pg.lam]).cpu()
    xc = torch.cat([pc.u, pc.u2, pc.lam])
    assert float((xg - xc).abs().max()) <= 1e-3 * float(xc.abs().max())
    assert launches["laplace_stencil_2d"] > 0
    assert launches["laplace_stencil_2d:f64"] > 0


def test_off_lattice_a22_inverse_is_full_float32(cuda):
    """The convergence study's immersed ball (cycle 0, off the lattice) puts
    A22's preconditioner on the dense inverse of its surrogate, applied as a
    float32 matmul on the card: TF32 must be off, and the apply must match
    the float64 NumPy inverse to float32 rounding, entry by entry against
    |A⁻¹||v| (TF32's 10-bit mantissa misses that bound several times
    over).  The
    exact W⁻¹ (W = M², dense below DENSE_INV_MAX) runs in the float64
    operator and matches NumPy to float64 rounding."""
    from fictitious_domain_al_preconditioners_torch.models import \
        EllipticInterfaceProblem

    cfg = S.elliptic_config()
    cfg.do_convergence_study = True
    prob = EllipticInterfaceProblem(cfg, device=cuda).setup(0)
    assert prob.fg_gridspace is None and prob.dtype == torch.float32
    parts = prob._solver_parts()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    n = prob.fg_space.n_dofs
    assert n <= 4000
    gamma_2 = prob._gammas()[1]
    inv = np.linalg.inv(prob.A2_scale * prob.A2.to_dense()
                        + gamma_2 * np.eye(n))
    v = np.random.default_rng(0).standard_normal(n)
    got = parts["A22_prec"](torch.as_tensor(v, device=cuda)).cpu().numpy()
    assert np.all(np.abs(got - inv @ v) <= 2e-5 * (np.abs(inv) @ np.abs(v)))
    m_inv = np.linalg.inv(prob.M.to_dense())
    w = prob._blocks()["inv_w"](torch.as_tensor(v, device=cuda))
    ref = m_inv @ (m_inv @ v)
    assert np.abs(w.cpu().numpy() - ref).max() <= 1e-10 * np.abs(ref).max()


def test_band_stencil_and_mass_inverse_match_cpu(cuda):
    """The band stencil of γ·Cᵀdiag(w)C and the banded lattice mass inverse
    (both forms) on the card against the same functions on the CPU."""
    from fictitious_domain_al_preconditioners_torch.core import (
        GridSpace, background_grid_from_name, immersed_mesh_from_name)
    from fictitious_domain_al_preconditioners_torch.core.immersed import \
        ImmersedSpace
    from fictitious_domain_al_preconditioners_torch.ops.coupling import \
        build_coupling
    from fictitious_domain_al_preconditioners_torch.ops.sparse import (
        COO, spgemm_ctwc)
    from fictitious_domain_al_preconditioners_torch.ops.sparse_band import \
        lattice_band_linop
    from fictitious_domain_al_preconditioners_torch.precond.weights import \
        lattice_mass_inverse

    args = "-0.14: 0.44: true"
    space = GridSpace.q(background_grid_from_name(
        "hyper_cube", "-1: 1: true", 2, 8), 1)
    fg = GridSpace.q(background_grid_from_name("hyper_cube", args, 2, 6), 1)
    fg_space = ImmersedSpace(immersed_mesh_from_name("hyper_cube", args, 2, 6),
                             fg.fe, fg.cell_dofs, fg.n_dofs)
    C = build_coupling(space, fg_space, order=2, device="cpu")
    w = np.random.default_rng(0).uniform(0.5, 2.0, fg.n_dofs)
    coo = spgemm_ctwc(COO.from_coupling(C), w)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(space.n_dofs),
                        dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal(fg.n_dofs), dtype=torch.float32)
    band = [lattice_band_linop(space, coo, scale=10.0, device=d,
                               dtype=torch.float32)[0] for d in (cuda, "cpu")]
    assert _rel(band[0](x.to(cuda)).cpu(), band[1](x)) <= 1e-5
    for squared in (False, True):
        inv = [lattice_mass_inverse(fg, squared=squared, device=d,
                                    dtype=torch.float32) for d in (cuda, "cpu")]
        assert _rel(inv[0](y.to(cuda)).cpu(), inv[1](y)) <= 1e-5


def test_small_stokes_matches_cpu(cuda):
    """The Stokes problem in chip_smoke.py's configuration at 4:5, float32
    V-cycle and float64 operator and Krylov solvers, on the card against
    the CPU: outer counts within 1, every block within 1e-3 of its max
    (``chip_smoke.phase_stokes_crosscheck`` raises otherwise)."""
    out = S.phase_stokes_crosscheck(cuda)
    assert all(out["converged"])


@pytest.mark.parametrize("pair,spacedim", [("4:5", 2), ("3:0", 3)])
def test_stokes_levels_and_vcycle_match_cpu(cuda, pair, spacedim):
    """The float32 velocity hierarchy of the Stokes problem (the vector band
    stencil on the 2D coarse levels, the element form with the coupling
    applies elsewhere) on the card against the CPU: every level operator
    and one V-cycle."""
    from fictitious_domain_al_preconditioners_torch.models import \
        StokesProblem

    probs = [StokesProblem(S.stokes_config(pair, spacedim), device=d,
                           dtype=torch.float32).setup() for d in (cuda, "cpu")]
    gmgs = [p._al_parts()["gmg"] for p in probs]
    routes = probs[1].results["gmg_routes"]
    assert probs[0].results["gmg_routes"] == routes
    assert ("band" in routes) == (spacedim == 2)
    rng = np.random.default_rng(0)
    for lg, lc in zip(gmgs[0].levels, gmgs[1].levels):
        x = torch.as_tensor(rng.standard_normal(lc.mask.numel()),
                            dtype=torch.float32)
        assert _rel(lg.op(x.to(cuda)).cpu(), lc.op(x)) <= 1e-5
    b = torch.as_tensor(rng.standard_normal(probs[1].layout.sizes[0]),
                        dtype=torch.float64) * probs[1].free
    assert _rel(gmgs[0].apply(b.to(cuda)).cpu(), gmgs[1].apply(b)) <= 1e-4


@pytest.mark.parametrize("form", list(S.AL_FORMS))
def test_small_al_forms_match_cpu(cuda, form):
    """The augmented solver's exact-W operator form and its explicit forms
    at refinement 6 on the card against the CPU (float32 on both): outer
    counts within 1, u within 1e-3 of its max; the explicit forms launch K1
    on the card, the exact-W form K1 and the patched K2."""
    def make(dev):
        prob = ImmersedLaplaceProblem(S.al_form_config(6, form), device=dev,
                                      dtype=torch.float32).setup()
        prob.solve()
        return prob, (prob.u, prob.lam)

    K.reset_launch_counts()
    out = S._crosscheck(f"{form}@6", make, cuda)
    assert all(out["converged"])
    assert K.LAUNCHES.get("masked_laplace_2d", 0) > 0
    assert (K.LAUNCHES.get(K.launch_key("op"), 0) > 0) == (form == "exactw")


def test_small_nitsche_and_elasticity_match_cpu(cuda):
    """The nitsche problem at cycle 0 and the 3D elasticity problem at
    background refinement 2, immersed 1 (to a reduction of 1e-10), on the
    card against the CPU (float32 V-cycles, float64 operators and Krylov
    solvers): outer counts within 1, every block within 1e-3 of its max;
    no kernel is launched on either path."""
    K.reset_launch_counts()
    outs = S.phase_family_crosscheck(cuda)
    assert all(all(o["converged"]) for o in outs)
    assert sum(K.LAUNCHES.values()) == 0, K.LAUNCHES


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_adaptive_flagship_matches_cpu(cuda, dtype):
    """flower_f1_g1.prm with one local refinement step at (6, 7), float32
    under the flagship's rule and float64 at the file's 1e-10, on the card
    against the CPU: outer counts within 1, u and λ within 1e-3 of their
    max in float32 and within 1e-7 in float64 (which a float32 solve would
    not meet); the element-form path launches no kernel."""
    def make(dev):
        prob = ImmersedLaplaceProblem(
            S.adaptive_config(S.ADAPTIVE_SCALE_FILE, (6, 7),
                              dtype == torch.float32), device=dev,
            dtype=dtype).setup()
        prob.solve()
        return prob, (prob.u, prob.lam)

    K.reset_launch_counts()
    out = S._crosscheck(f"adaptive_flower@6:7:{dtype}", make, cuda,
                        1e-3 if dtype == torch.float32 else 1e-7)
    assert all(out["converged"])
    assert sum(K.LAUNCHES.values()) == 0, K.LAUNCHES


def test_adaptive_stokes_matches_cpu(cuda):
    """The Stokes problem at 4:5 with one local refinement step (float32
    V-cycle, float64 operator and Krylov solvers) on the card against the
    CPU; every level is element form, no kernel is launched."""
    from fictitious_domain_al_preconditioners_torch.models import \
        StokesProblem

    def make(dev):
        cfg = S.stokes_config("4:5")
        cfg.delta_refinement = 1
        prob = StokesProblem(cfg, device=dev, dtype=torch.float32).setup()
        prob.solve()
        assert set(prob.results["gmg_routes"]) == {"element"}
        return prob, (prob.u, prob.p, prob.lam)

    K.reset_launch_counts()
    out = S._crosscheck("adaptive_stokes@4:5+1", make, cuda)
    assert all(out["converged"])
    assert sum(K.LAUNCHES.values()) == 0, K.LAUNCHES


@pytest.mark.parametrize("kdeg", [0, 2], ids=["dg0", "q2"])
def test_multiplier_degree_kernels_match_plain(cuda, kdeg):
    """The flagship with a DG0 and a Q2 multiplier at refinement 9 on the
    card: K1, K6 and K2 ``op``/``pre``/``post`` launched on its path, and
    each against its plain version at every level shape of that path with
    its patch planes and Lanczos bounds (chip_smoke's tolerances)."""
    cfg = S.flagship_config(9)
    cfg.embedded_space_degree = kdeg
    K.reset_launch_counts()
    prob = ImmersedLaplaceProblem(cfg, device=cuda).setup()
    _, _, info = prob.solve()
    launches = dict(K.LAUNCHES)
    assert info.converged and not prob.element_form
    for key in ["masked_laplace_2d", "laplace_stencil_2d"] + [
            K.launch_key(m) for m in ("op", "pre", "post")]:
        assert launches.get(key, 0) > 0, key
    errs = S.phase_flagship_shapes(prob, cuda, "test")
    assert len(errs) > 0


@pytest.mark.parametrize("case", range(8))
def test_option_paths_match_cpu(cuda, case):
    """chip_smoke's phase 14 card-against-CPU checks, one case each (the
    DG0 and Q2 flagship at refinement 7, the element-form flower with both
    degrees and the bf16 V-cycle, elliptic with a Q2 background and a Q2
    immersed space, elasticity with a Q2 background): counts within 1,
    blocks within 1e-3 of their max."""
    tag, make = S.options_crosscheck_cases()[case]
    out = S._crosscheck(tag, make, cuda)
    assert all(out["converged"])
