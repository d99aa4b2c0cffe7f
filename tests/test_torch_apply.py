"""The two single-application kernels of the PyTorch port that share K1's
register window, K6 and K2's ``op`` with the patch, against the JAX package:
the plain K6 against ``laplace_stencil_2d(h0, h1)(u, use_pallas=False)``
(float32 to 1e-6, float64 to 1e-12, down to 3 x 3 and on non-square cells);
the plain patched ``op`` against ``fused_chebyshev_2d(..., interpret=True,
mode="op")`` over boxes at the lattice's border, of one row, one column and
one point (float32, the bound of tests/test_fused_cheb.py); the CUDA sources
of the two kernels; and the Python mirror of the window's tile and plan,
which the edge shapes of the card tests and of ``chip_smoke.py`` rest on."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as S
from fictitious_domain_al_preconditioners_tpu.ops.pallas_kernels import (
    fused_chebyshev_2d, laplace_stencil_2d as j_stencil, stencil_factors_2d)
from fictitious_domain_al_preconditioners_torch.ops import kernels as K

torch.set_num_threads(1)

CSRC = os.path.dirname(K.SOURCES[0])


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# (lattice, cell sizes): the smallest lattice, one of three rows and one of
# three columns, a coarse level, non-square lattices with an even and an odd
# row length, and cells that are not square on a square lattice
K6_CASES = {"n3": ((3, 3), None), "n3x40": ((3, 40), None),
            "n40x3": ((40, 3), None), "n5": ((5, 5), None),
            "n17x33": ((17, 33), None), "n64x130": ((64, 130), None),
            "n33_h": ((33, 33), (0.1, 0.37))}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", list(K6_CASES))
def test_k6_plain_matches_jax_stencil(name, dtype):
    shape, h = K6_CASES[name]
    h = h or (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    assert h[0] != h[1] or shape[0] == shape[1]
    u = np.random.default_rng(11).standard_normal(shape).astype(dtype)
    ref = j_stencil(*h)(jnp.asarray(u), use_pallas=False)
    got = K.laplace_stencil_2d(torch.as_tensor(u), h)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    assert rel_err(got, ref) <= (1e-6 if dtype == "float32" else 1e-12)


# patch boxes (r0, c0, pr, pc) on a (33, 47) lattice: one point, one row, one
# column, touching row 1, column 1 and row ny - 2 (the interior's edges), the
# whole interior, and the whole lattice (planes on boundary points, masked)
OP_SHAPE = (33, 47)
OP_BOXES = {"point": (16, 20, 1, 1), "row": (9, 5, 1, 30),
            "column": (4, 40, 20, 1), "row1": (1, 10, 6, 12),
            "column1": (8, 1, 10, 7), "row_ny-2": (25, 12, 7, 20),
            "interior": (1, 1, 31, 45), "lattice": (0, 0, 33, 47)}


@pytest.mark.parametrize("name", list(OP_BOXES))
def test_patched_op_plain_matches_fused_interpret(name):
    ny, nx = OP_SHAPE
    r0, c0, pr, pc = box = OP_BOXES[name]
    h = (1.0 / (ny - 1), 1.0 / (nx - 1))
    rng = np.random.default_rng(12)
    planes = rng.uniform(0.1, 1.0, (5, pr, pc)).astype(np.float32)
    full = np.zeros((5, ny, nx), np.float32)
    full[:, r0:r0 + pr, c0:c0 + pc] = planes
    jfn = fused_chebyshev_2d(stencil_factors_2d(h), OP_SHAPE, full, box, 1.2,
                             degree=4, eig_ratio=30.0, dtype=jnp.float32,
                             interpret=True, mode="op")
    st = K.AugmentedStencil2D(h, OP_SHAPE, torch.as_tensor(planes), box)
    b = rng.standard_normal(OP_SHAPE).astype(np.float32)
    ref = np.asarray(jfn(jnp.asarray(b)))
    got = K.fused_augmented_2d("op", st, torch.as_tensor(b)).numpy()
    assert rel_err(got, ref) <= 2e-5
    # the boundary is the input, bit for bit
    for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_array_equal(got[edge], b[edge])


def _constant(source, name):
    text = open(os.path.join(CSRC, source)).read()
    m = re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);", text)
    assert m, f"{name} not found in {source}"
    return int(eval(m.group(1).replace("ll", ""), {"__builtins__": {}}))


def test_window_mirror_matches_the_header():
    assert K.WINDOW_KEEP == _constant("fdal_window.cuh", "KEEP")
    assert K.WINDOW_WARPS == _constant("fdal_window.cuh", "WARPS")
    assert K._MIDDLE_POINTS == _constant("fdal_window.cuh", "MIDDLE_POINTS")
    assert K._LARGE_POINTS == _constant("fdal_window.cuh", "LARGE_POINTS")
    assert K.PATCH_CHUNK == _constant("fdal_augmented.cu", "PATCH_CHUNK")
    # size_plan: one row, one chunk of 4 rows, chunks of 8 rows in runs of
    # 32 bytes of column
    text = open(os.path.join(CSRC, "fdal_window.cuh")).read()
    for line in ("if (points < MIDDLE_POINTS) return Plan{1, 1};",
                 "if (points < LARGE_POINTS) return Plan{4, 4};",
                 "return Plan{8, 32 / bytes};"):
        assert line in text, line
    tile = K.window_plan
    assert tile(362, 362) == dict(chunk_rows=1, run_rows=1, tile_columns=120)
    assert tile(363, 362) == dict(chunk_rows=4, run_rows=4, tile_columns=120)
    assert tile(2048, 2047) == tile(363, 362)
    assert tile(2048, 2048) == dict(chunk_rows=8, run_rows=8,
                                    tile_columns=120)
    assert tile(2048, 2048, itemsize=2)["run_rows"] == 16


def test_edge_shapes_sit_on_the_window_tile():
    """What the edge-shape generators of ``chip_smoke.py`` assume of the
    tile: each plan is met, with rows one point either side of a multiple of
    the run and of the 30 kept columns; every patch box lies in its lattice
    and the boxes on tile edges begin and end where a run and a warp do."""
    shapes = S.window_edge_shapes()
    assert {(3, 3), (5, 5), (9, 9), (17, 17)} <= set(shapes)
    plans = {K.window_plan(*s)["run_rows"] for s in shapes}
    assert plans == {1, 4, 8}
    for run in plans:
        mine = [s for s in shapes if K.window_plan(*s)["run_rows"] == run
                and min(s) > 40]
        assert {s[0] % run for s in mine} >= {0, 1 % run, (run - 1) % run}
        assert {s[1] % K.WINDOW_KEEP for s in mine} >= {0, 1, 2, 28, 29}
    cases = S.op_edge_cases()
    assert len(cases) == len(set(cases)) >= 40
    assert {K.window_plan(*s)["run_rows"] for s, _ in cases} == {1, 4, 8}
    on_tile = 0
    for (ny, nx), (r0, c0, pr, pc) in cases:
        assert 0 <= r0 and r0 + pr <= ny and 0 <= c0 and c0 + pc <= nx
        assert pr > 0 and pc > 0
        run = K.window_plan(ny, nx)["run_rows"]
        if (pr > 1 and r0 % run == 0 and (r0 + pr) % run == 0 and r0 > 0
                and c0 % K.WINDOW_KEEP == 0
                and (c0 + pc) % K.WINDOW_KEEP == 0 and c0 > 0):
            on_tile += 1
    assert on_tile >= 6
    assert sum(box[2:] == (1, 1) for _, box in cases) >= 12


def test_window_sources_are_built_and_share_the_header():
    names = [os.path.basename(p) for p in K.SOURCES]
    assert "fdal_augmented.cu" in names
    assert [os.path.basename(p) for p in K.HEADERS] == ["fdal_sweep.cuh",
                                                        "fdal_window.cuh"]
    for name in ("fdal_masked.cu", "fdal_augmented.cu", "fdal_stencil.cu"):
        text = open(os.path.join(CSRC, name)).read()
        assert '#include "fdal_window.cuh"' in text, name
    aug = open(os.path.join(CSRC, "fdal_augmented.cu")).read()
    for fn in ("fdal_augmented_op_2d", "fdal_augmented_op_resources",
               "fdal_augmented_op_plan"):
        assert f"int {fn}(" in aug
    # the sweep template no longer serves op with the patch; the build hash
    # covers every source and header (tests/test_torch_kernels.py)
    sweep = open(os.path.join(CSRC, "fdal_kernels.cu")).read()
    assert "run_form<MODE_OP" not in sweep
    assert "run<MODE_OP, 2, false>" in sweep


def test_patched_op_on_the_cpu_takes_the_plain_version():
    before = K._library.cache_info()
    launches = dict(K.LAUNCHES)
    st = S.random_patch_stencil((17, 29), (3, 4, 5, 6), "cpu", seed=1)
    b = torch.ones((17, 29))
    got = K.fused_augmented_2d("op", st, b)
    assert torch.equal(got, K.fused_augmented_2d_plain("op", st, b))
    K.laplace_stencil_2d(b, st.h)
    assert K._library.cache_info() == before
    assert K.LAUNCHES == launches
    meta = K.AugmentedStencil2D((0.125, 0.125), (9, 9), torch.zeros(
        (5, 3, 3), device="meta"), (3, 3, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_augmented_2d("op", meta, torch.empty((9, 9), device="meta"))
