#!/usr/bin/env python3
"""Drive the PyTorch port's immersed_laplace, elliptic interface, Stokes,
nitsche and elasticity interface solves on one CUDA card, on uniform and on
locally refined backgrounds.

    python3 chip_smoke.py                  # all phases, refinement 12
    python3 chip_smoke.py --refinement 9   # the same at a quick size
    python3 chip_smoke.py --elliptic-cycle 4 --elliptic-only
    python3 chip_smoke.py --stokes-refinement 7:8 --stokes3d-refinement 4:1 \
        --stokes-only
    python3 chip_smoke.py --families-only
    python3 chip_smoke.py --elasticity-only --elasticity-cycle 3
    python3 chip_smoke.py --adaptive-only  # phases 12 and 13
    python3 chip_smoke.py --options-only   # phase 14
    python3 chip_smoke.py --table-only     # phase 15
    python3 chip_smoke.py --sharded-only   # phase 16
    python3 chip_smoke.py --kernels-only   # phases 1-2, K2 rows timed

Phases (any failure exits non-zero before the last line is printed):

1. device: require CUDA, print the card's name and power limit, build the
   kernels from ``fictitious_domain_al_preconditioners_torch/csrc`` and
   print what both forms of K1, both forms of K6, the patched K2 ``op``
   (each in every chunk) and each K2 instantiation of the main paths take
   of the card (registers a thread, shared memory, spilled bytes, blocks an
   SM);
2. kernels against their plain PyTorch versions on the card: K1 (float32
   and its bf16-storage form), K6 (float32 and float64), and K2 in all four
   modes with patch planes (from flagship couplings) and without, in
   float32 and in bf16 storage, at n = 65, n = 1025 and (530, 777); K1's
   two forms, K6's two forms and the
   patched K2 ``op`` also at the edge shapes of their tile (lattices one and
   two points either side of a multiple of it, shorter than a thread's run,
   narrower than a warp, without interior; for ``op``, patch boxes whose
   edges fall on a warp's first and last kept column, on a run's first and
   last row, at the lattice's border and one point off it, and boxes of one
   point), where the boundary must equal the input bit for bit (K1,
   ``op``);
3. the flagship solve (``bench.py``'s configuration, ``solver="augmented"``)
   at the refinement: a warm-up solve, then a timed solve, through
   ``ImmersedLaplaceProblem(cfg).setup()`` and ``.solve()``; the launch
   counters must show K1, K6 and K2 ``op``/``pre``/``post`` on that path;
   afterwards every kernel is compared with its plain version again at the
   shapes that path gave it, and timed at the fine level (K1 in the same
   turns as a device copy of the lattice and the no-patch K2 ``op``, which
   computes the same function; every K2 mode also as device ms in a CUDA
   graph), and K1's two forms, K6 and the patched K2 ``op`` (with each
   level's own patch box) are timed at every level shape of the hierarchy
   in a CUDA graph beside a device copy and K1;
5. the ``rational`` and ``CG`` modes at the refinement and ``ELMAN_triang``
   at refinement 9 (at most the refinement), on the f = 0, g = 1 circle with
   the flagship's stopping rule, each a warm-up and a timed solve; the
   counters must show K1, K6 and K2 without patch ``pre``/``post`` on each
   path; afterwards the kernels are compared with their plain versions at
   the shapes those paths gave them, and K6 and the no-patch K2 are timed at
   the fine level (K6 also against ``torch.nn.functional.conv2d``);
6. the mixed-precision flagship: the flagship with the bf16 V-cycle
   (``use_bf16_multigrid``) at the refinement, a warm-up and a timed solve;
   it must converge within 2 outer iterations of phase 3's count, with
   K2's bf16 form (``op``, ``pre``, ``post``, the levels whose band is
   interior) and K1's (the others) launched; both are compared with their
   plain versions at every level shape of that path (K2 with each level's
   planes) and timed at the fine level (K2 in every mode); then
   ``solve_refined(tol_abs=1e-10)`` at refinement 11 (at most the
   refinement), once with the float32 V-cycle (``bench.py``'s ``refined``
   row) and once with the bf16 V-cycle, each to a true float64 residual of
   at most 1e-10;
7. the elliptic interface problem (``EllipticInterfaceProblem``) in the
   results table's configuration (modified AL, β₂ = 1e3, γ = 10 / 1e-2,
   fixed inner iterations, W = M² exact; ``scripts/make_results_table.py``)
   at cycle 6 (``--elliptic-cycle``; 4,198,401 + 263,169 dofs): ``solve()``
   and then ``solve_refined(tol_abs=1e-10)`` on the same operators; the
   true float64 residual must reach 1e-10 and both forms of K6 must be
   launched (float64 in the outer operator and the inner CGs, float32 in the
   V-cycles); both are compared with their plain versions at every level
   shape of both GMG hierarchies, and the float64 form is timed at the fine
   background lattice;
8. the Stokes problem (``StokesProblem``, IBStokesAL) in the results
   table's configuration (grad-div, W = diag(M_Γ)⁻², outer tolerance 3e-4
   and reduction 1e-5; ``scripts/make_results_table.py:88-124``): 2D at
   9:10 (``--stokes-refinement``; 2,101,250 + 263,169 + 2,050 dofs, the
   row the TPU never ran) with ``setup()``, ``solve()`` and
   ``solve_refined(tol_abs=1e-8)`` on the operators the solve built, then
   3D at 5:2 (``--stokes3d-refinement``; 823,875 + 35,937 + 294 dofs; a
   sphere, g = (-1, 1, 0), body force (1, 0, 0)) with
   ``solve_refined(tol_abs=1e-8)``; the true float64 residual must reach
   1e-8.  The Stokes path launches none of the kernels: every apply is
   PyTorch (its launch counts are printed, all 0);
9. the augmented solver's other AL forms on the flagship's data and
   stopping rule: the operator form with the exact W = M at the refinement
   (``exactw``: the flagship's lattice path, K1 and K2 must be launched) and
   the explicit form with W = diag(M)² and W = M² at refinement 11 (at
   most the refinement; the fine compact AL block must form within 30 s):
   K1 and the masked compact block on every level, K1 must be launched;
   the block's rows, bytes and seconds are printed; a warm-up and a timed
   solve each; the kernels of each path are compared with their plain
   versions at its level shapes.  Phase 5 also runs the
   rational mode at refinements 7-9 under the results table's rule, beside
   the TPU's counts, each within 1 of the JAX package's float32 count on
   the CPU;
10. the nitsche problem (``NitscheProblem``, the manufactured solution of
    the results table) at cycles 0-4 (289 ... 66,049 bulk dofs) and 7
    (refinement 11, at most the refinement; 4,198,401 + 8,192 dofs):
    ``solve_refined(tol_abs=1e-10)`` on every row, whose true float64
    residual must reach 1e-10, with the inner CG iterations per outer
    iteration and the L2/H1 errors and rates (the last L2 rate of the study
    above 1.6);
11. the 3D elasticity interface problem (``ElasticityInterfaceProblem``,
    the results table's configuration) at cycles 0 and 1
    (``--elasticity-cycle``; cycle 2, 107,811 + 14,739 + 14,739 dofs, and
    the scale row at cycle 3, 823,875 + 107,811 + 107,811, are cut from the
    default run for their time): ``solve()``, then
    ``solve_refined(tol_abs=1e-10)`` on every row, whose true float64
    residual must reach 1e-10, with the routes of both GMG hierarchies'
    levels.  Neither phase 10 nor 11 launches a kernel: their counts must
    stay 0;
12. immersed_laplace with one local refinement step near Γ (the
    element-form path: quadtree, compact AL block, flat GMG), read from
    ``parameters/{circle/circle_f0_g1,flower/flower_f1_g1,square/
    square_f1_g1}.prm`` by ``from_prm`` at the reference's (embedding 10,
    embedded 11) (:data:`ADAPTIVE_PAIR`): a warm-up and a timed float32
    solve under the flagship's rule, then a float64 solve at the file's
    own 1e-10; the flower also at (11, 12) in float32, within 2 outer
    iterations of its (10, 11) count; each file at its shipped size in
    float64 on the card and on the CPU, counts within 1 of each other and
    of the JAX package's CPU count (18, 16, 14); every row prints dofs,
    GMG levels, the compact block's rows and MB, setup, build and solve
    seconds, the constraint residual and peak GB;
13. Stokes with one local refinement step (``delta_refinement = 1``), 2D
    at 9 + 1:10 with ``solve()`` and ``solve_refined(tol_abs=1e-8)``, 3D
    at 6 + 1 around a sphere of refinement 4 (the reference's
    configuration) with ``solve_refined``; the true float64 residual must
    reach 1e-8, the tree must hold fewer background dofs than the uniform
    grid of its finest h, and every GMG level's route is printed (element
    form).  Neither phase 12 nor 13 launches a kernel; ``--adaptive-only``
    runs just them;
14. the options of the JAX package that the port took last: the flagship
    with a DG0 and a Q2 multiplier (``embedded_space_degree`` 0 and 2;
    16,785,409 + 4,096 and + 8,193 dofs at refinement 12) in operator form,
    K1, K6 and K2 ``op``/``pre``/``post`` launched and compared with their
    plain versions at the path's level shapes, and in the explicit form at
    refinement 11 (K1; the compact block's rows and MB); the element-form
    flower at (10, 11) + 1 with both degrees in float32 and with the bf16
    V-cycle at degree 1 (within 2 outer iterations of its float32 count);
    elliptic at cycle 4 with a Q2 background (1,050,625 + 16,641 dofs) and
    with a Q2 immersed space (263,169 + 66,049), and elasticity with a
    Q2 background at cycle 1 (107,811 + 2,187 + 2,187), each ``solve()``
    then ``solve_refined(tol_abs=1e-10)`` to a true float64 residual of at
    most 1e-10, K6's launches printed on the elliptic rows;
    ``--options-only`` runs just it and its cross-checks;
15. the host setup and the H100 results table's scripts: the C++ setup
    routines (``native.py``, built with ``g++`` from ``csrc/fdal_setup.cpp``)
    must be in use; point location, tabulation and COO deduplication on the
    coupling quadrature points of elliptic cycle 6 and the compact-AL
    accumulation on the fine block of the flower at (11, 12) + 1 must equal
    their NumPy forms (cells, rows and columns exactly; values within
    1e-14, 1e-13 and 1e-12 of their max), each form's seconds printed; then
    ``scripts/measure_family_torch.py`` measures the smallest row of each
    family of the table (one process a family, all at once, ``jax``
    blocked) into a temporary cache, ``make_results_table_torch.py``
    renders it, and every row must have converged with finite numbers; the
    rows' launch counts (set to 0 before each row, read after it) must show
    K1 and K2 on laplace@7 and both forms of K6 on elliptic@0;
    ``--table-only`` runs just it;
16. the row-block sharded flagship (``build_sharded_solver``, run after
    phase 3), held to a serial solve of phase 3's configuration
    (``parallel.dryrun.serial_reference``; a second serial solve with
    deterministic algorithms off prints the serial path's own spread):
    ``parallel.mesh.launch`` runs the sharded solve on one rank over NCCL
    and on two ranks sharing the card (gloo, halos staged through the
    host), and ``parallel.dryrun.compare_to_serial`` holds each within
    ``parallel.dryrun.SERIAL_LIMITS``: the outer count (equal on one rank,
    within 1 on two), u (relative max-norm 1e-5 on one rank, 5e-4 on two:
    float32 solves stopped by this rule differ by about 1e-4 with no
    fault), and one application of the fine level's operator and of the
    V-cycle to a seeded vector (1e-6 and 1e-6 on one rank, 1e-6 and 1e-5
    on two: no inner stop, so a halo or reduction fault shows); every
    rank's launch counts must show K6 and K2 ``op``/``pre``/``post`` (K1
    where its replicated tail has a compact level), and on every rank each
    kernel is compared with its plain version at the rank's shapes (the
    extended blocks with their clipped patch boxes, the tail's lattices);
    one JSON line a run (world size, backend, transport, outer iterations,
    the drifts and their limits, setup/build/solve seconds, collectives and
    halo bytes a solve, peak GB and launches per rank, the card); NCCL with
    one rank a card runs only where two or more cards are seen; then the
    other configurations (``SHARDED_FORMS``) on two ranks sharing the card,
    all in one start of the ranks, each held to a serial solve of its own
    (run in this process while the ranks run) within its
    ``SERIAL_LIMITS``: the exact W and the bf16 V-cycle at the
    refinement, both explicit forms and a fine Γ-band on ∂Ω (the circle at
    (.2, .5)) at 11, the flower at (10, 11) + 1 (the element form); each
    rank must have launched K6 and the fine level's kernels (K2
    ``op``/``pre``/``post``; K2 ``op`` and K1 bf16 under the bf16 V-cycle;
    K1 in the explicit forms and on the band; none on the element form),
    every kernel compared with its plain version at the rank's shapes; then
    ``dryrun_multichip(2)`` (two gloo ranks on the CPU with one card);
    ``--sharded-only`` runs just it;
4. cross-check at refinement 7: the card (kernels) against the CPU (plain
   versions) in float32 with the same Lanczos start vectors, for the
   flagship, the three modes and the flagship with the bf16 V-cycle; the
   elliptic problem at cycle 1 and the Stokes problem at 4:5 (float32
   V-cycles, float64 operator and Krylov solvers on both), whose outer
   counts must agree within 1 and whose three solution blocks within 1e-3
   of each block's max; likewise the three AL forms of phase 9 at
   refinement 7, the nitsche problem at cycle 0 and the elasticity problem
   at background refinement 2, immersed 1 (to a reduction of 1e-10); and
   phase 14's paths at a small size (the DG0 and Q2 flagship at refinement
   7, the flower at its shipped size, elliptic at cycle 0, elasticity at
   2, 1).

Launch counts are set to 0 just before each path (phases 3, 5, 6, 7, 8, 9,
10, 11, 12, 13, 14, the rows of 15 and each rank of 16) and read just
after it. The three
last lines are the card's name and power limit, a JSON object with one
entry per kernel, and ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

PKG = "fictitious_domain_al_preconditioners_torch"
SOURCE = {"masked_laplace_2d": f"{PKG}/csrc/fdal_masked.cu",
          "masked_laplace_2d:bf16": f"{PKG}/csrc/fdal_masked.cu",
          "fused_augmented_2d": f"{PKG}/csrc/fdal_sweep.cuh",
          "laplace_stencil_2d": f"{PKG}/csrc/fdal_stencil.cu",
          "laplace_stencil_2d:f64": f"{PKG}/csrc/fdal_stencil.cu"}
# the file that instantiates each K2 mode (the kernel is fdal_sweep.cuh),
# but for op with the patch, whose kernel is in a file of its own
MODE_SOURCE = {"op": f"{PKG}/csrc/fdal_augmented.cu",
               "op:no_patch": f"{PKG}/csrc/fdal_kernels.cu",
               "smooth": f"{PKG}/csrc/fdal_kernels.cu",
               "pre": f"{PKG}/csrc/fdal_pre.cu",
               "post": f"{PKG}/csrc/fdal_post.cu",
               "bf16": f"{PKG}/csrc/fdal_sweep_bf16.cu"}
_TPU = "fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py"
REPLACES = {"masked_laplace_2d": f"{_TPU}:193",
            "masked_laplace_2d:bf16": f"{_TPU}:193",
            "fused_augmented_2d": f"{_TPU}:394",
            "laplace_stencil_2d": f"{_TPU}:31",
            "laplace_stencil_2d:f64": f"{_TPU}:31"}
# max |kernel - plain| / max |plain|: one application vs the Chebyshev
# recurrence (the bounds of tests/test_fused_cheb.py) in float32; K1's bf16
# form, where a float32 sum order can flip one bf16 rounding (2^-8); K6's
# float64 form, another float64 summation order
TOL = {"masked_laplace_2d": 1e-6, "laplace_stencil_2d": 1e-6, "op": 1e-6,
       "smooth": 2e-5, "pre": 2e-5, "post": 5e-5,
       "masked_laplace_2d:bf16": 1e-2, "laplace_stencil_2d:f64": 1e-13}
# K2 in bf16 storage (every mode) against the float32 plain form on the same
# bf16 inputs and planes, before its rounding: half a bf16 ulp of the
# largest output, the kernel's one rounding a store
BF16_SWEEP_TOL = 2.0 ** -8
# the solver modes of phase 5 and the refinement of ELMAN_triang, the
# negative control whose counts grow with refinement (BASELINE.md:31)
MODE_SOLVERS = ("rational", "CG", "ELMAN_triang")
ELMAN_REFINEMENT = 9
# bench.py's refined row (REF_SMALL) and the reference configs' tolerance
REFINED_REFINEMENT = 11
REFINED_TOL = 1e-10
# the elliptic interface phase: the results table's largest cycle (the
# reference's 8-cycle scale) and the cycle of its card-against-CPU check
ELLIPTIC_CYCLE = 6
ELLIPTIC_CROSSCHECK_CYCLE = 1
# the Stokes phase: the results table's largest rows, 2D 9:10 (never run on
# the TPU) and 3D 5:2, to the reference's 1e-8 'Stokes solver control'
# (parameters_stokes.prm), and the rows of its card-against-CPU check
STOKES_2D = "9:10"
STOKES_3D = "5:2"
STOKES_TOL = 1e-8
STOKES_CROSSCHECK = "4:5"
# phase 9: the exact-W operator form at the flagship's refinement; the two
# explicit forms at EXPLICIT_REFINEMENT (at most the flagship's), whose fine
# compact AL block the setup must form within COMPACT_SETUP_LIMIT_S
EXPLICIT_REFINEMENT = 11
COMPACT_SETUP_LIMIT_S = 30.0
AL_FORMS = {"exactw": (True, False), "explicit": (False, True),
            "explicit_exactw": (False, False)}
# phase 5's open cell: the rational mode at refinements 7-9 under the
# results table's rule: refinement -> (the TPU's float32 count,
# tables/results_tpu.md:44-46; the JAX package's float32 count on the CPU,
# tests/test_torch_rational_table*.py, which the card's must equal within 1)
RATIONAL_TABLE = {7: (37, 10), 8: (55, 10), 9: (37, 10)}
# phase 10: nitsche, the reference's 5-cycle study (parameters_nitsche.prm,
# scripts/make_results_table.py:193-219) and a scale row at refinement 11
NITSCHE_CYCLES = (0, 1, 2, 3, 4)
NITSCHE_SCALE_CYCLE = 7
# phase 11: elasticity 3D in the results table's configuration
# (scripts/make_results_table.py:222-246), cycles 0 to this one; cycle 3
# (1,039,497 dofs) ran past the script's time limit (PERF.md §4), and
# with cycle 2 and phase 14's elliptic rows at cycle 5 the whole script took
# 1,340.8 s of its 1,200 (PERF.md §6, PR 13); ``--elasticity-cycle 2`` runs
# it
ELASTICITY_CYCLE = 1
# phase 12: immersed_laplace with one local refinement step near Γ, read
# from the shipped parameter files; the reference's own scale (embedding
# 10, embedded 11: parameters/flower/flower_f1_g1.prm:2-5), the flower also
# at (11, 12), and each file at its shipped size, whose float64 outer count
# must equal the CPU's within 1: the port's on the CPU, and the JAX
# package's CLI in float64 on the CPU (18, 16, 14)
ADAPTIVE_FILES = ("parameters/circle/circle_f0_g1.prm",
                  "parameters/flower/flower_f1_g1.prm",
                  "parameters/square/square_f1_g1.prm")
ADAPTIVE_PAIR = "10:11"
ADAPTIVE_SCALE_FILE = "parameters/flower/flower_f1_g1.prm"
ADAPTIVE_JAX_CPU_COUNTS = {"circle_f0_g1": 18, "flower_f1_g1": 16,
                           "square_f1_g1": 14}
# phase 13: Stokes with one local refinement step: 2D parameters/
# stokes_al.prm's functions and AL settings at background 9 + 1, embedded
# 10 (phase 8's 9:10 row with the local step), and 3D the reference's
# configuration, background 6 + 1 around a sphere of refinement 4
# (scripts/make_results_table.py:317, :629); "ref:eref"
ADAPTIVE_STOKES_2D = "9:10"
ADAPTIVE_STOKES_3D = "6:4"
# phase 8's uniform rows on this card (PERF.md §6): solve_refined's outer
# iterations at 9:10 (2D) and 5:2 (3D), printed beside phase 13's
UNIFORM_STOKES_OUTER = {2: ("9:10", 38), 3: ("5:2", 12)}
# phase 14: the options the port refused before: a multiplier of degree 0
# (DG0) or 2 (Q2) on the flagship's lattice path at the refinement and in
# the explicit form at EXPLICIT_REFINEMENT; on the element-form flower
# (ADAPTIVE_SCALE_FILE at ADAPTIVE_PAIR) both degrees and the bf16 V-cycle
# at degree 1; elliptic with a Q2 background and with a Q2 immersed space at
# OPTIONS_ELLIPTIC_CYCLE (1,050,625 + 16,641 and 263,169 + 66,049 dofs;
# cycle 5 took about 250 s of the script's time, see ELASTICITY_CYCLE);
# elasticity with a Q2 background at OPTIONS_ELASTICITY_CYCLE (107,811 +
# 2,187 + 2,187 dofs, the dofs of the Q1 table's cycle 2); their
# card-against-CPU checks at OPTIONS_CROSSCHECK_REFINEMENT and cycle 0
OPTION_DEGREES = (0, 2)
OPTION_SUFFIX = {0: "_dg0", 1: "", 2: "_q2"}
OPTIONS_ELLIPTIC_CYCLE = 4
OPTIONS_ELASTICITY_CYCLE = 1
OPTIONS_CROSSCHECK_REFINEMENT = 7
# phase 15: the host setup routines at elliptic cycle 6's coupling points
# and the flower's (11, 12) + 1 compact AL block; the smallest row of each
# family of the results table (scripts/make_results_table_torch.py), and
# the kernels each row must launch
NATIVE_ELLIPTIC_CYCLE = 6
NATIVE_FLOWER_PAIR = (11, 12)
TABLE_SMOKE_ROWS = {"laplace": "7", "refined": "9", "rational": "5",
                    "elliptic": "0", "stokes": "4:5", "stokes3d": "3:0",
                    "nitsche": "0", "elasticity": "0"}
TABLE_SMOKE_LAUNCHES = {
    "laplace:7": ("masked_laplace_2d", "fused_augmented_2d:op",
                  "fused_augmented_2d:pre", "fused_augmented_2d:post"),
    "elliptic:0": ("laplace_stencil_2d", "laplace_stencil_2d:f64")}
# phase 16: the row-block sharded flagship at the refinement, on one rank
# over NCCL and on SHARDED_RANKS ranks sharing the one card (gloo, halos
# staged through the host); how far each may lie from the serial solve is
# parallel.dryrun.SERIAL_LIMITS
SHARDED_RANKS = 2
SHARDED_TIMEOUT_S = 600
# phase 16's other configurations, each on SHARDED_RANKS ranks sharing the
# card (one start of the ranks for all of them), held to a serial solve of
# the same configuration: the exact W and the bf16 V-cycle at the
# refinement, the explicit forms and a fine Γ-band on ∂Ω (the flagship
# circle moved to (.2, .5), tangent to the side x = 0) at
# EXPLICIT_REFINEMENT, the flower at ADAPTIVE_PAIR + 1 (the element form)
SHARDED_FORMS = ("exactw", "bf16", "explicit", "explicit_exactw", "band",
                 "flower")
SHARDED_BAND_CIRCLE = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                       "R=.2, Cx=.2, Cy=.5")
SHARDED_FORMS_TIMEOUT_S = 900
ROOT = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 and float64 rates
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
# operations of one 9-point tensor-product stencil apply per point: 3
# column sums (1 add) each feeding two 3-term factors (2 mul + 1 add each),
# then 6 mul + 3 add in the row combination
STENCIL_FLOPS = 30


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def flagship_config(refinement, bf16=False):
    """``bench.py``'s flagship configuration (bench.py:48-62); ``bf16`` runs
    its V-cycle in bfloat16 (``use_bf16_multigrid``)."""
    from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
        import ImmersedLaplaceConfig

    cfg = ImmersedLaplaceConfig(
        initial_refinement=refinement,
        initial_embedded_refinement=refinement,
        embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                "R=.2, Cx=.4, Cy=.4"),
        embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
        embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
        solver="augmented",
        use_operator_form=True,
        use_diagonal_inverse=True,
        use_bf16_multigrid=bf16,
    )
    cfg.schur.tolerance = 3e-5
    cfg.schur.reduction = 1e-6
    return cfg


def mode_config(solver, refinement):
    """The f = 0, g = 1 circle of tests/test_baseline_tables.py:25-38 for
    ``solver``, with the flagship's float32 stopping rule."""
    from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
        import ImmersedLaplaceConfig

    cfg = ImmersedLaplaceConfig(
        initial_refinement=refinement,
        initial_embedded_refinement=refinement,
        embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                "R=.2, Cx=.4, Cy=.4"),
        embedding_rhs=("0", ""), embedded_value=("1", ""), solver=solver)
    cfg.schur.tolerance = 3e-5
    cfg.schur.reduction = 1e-6
    cfg.schur.max_steps = 1000
    return cfg


def elliptic_config():
    """The results table's elliptic interface configuration
    (scripts/make_results_table.py:67-73): modified AL, β₂ = 1e3, γ = 10 on
    the background and 1e-2 on the immersed box, fixed inner iterations,
    W = M² exact, outer tolerance 3e-5 and reduction 1e-5, background
    refinement 5 and immersed 3 at cycle 0."""
    from fictitious_domain_al_preconditioners_torch.models import \
        EllipticInterfaceConfig

    cfg = EllipticInterfaceConfig(
        initial_background_refinement=5, initial_immersed_refinement=3,
        beta_2=1e3, use_modified_AL_preconditioner=True,
        gamma_AL_background=10.0, gamma_AL_immersed=1e-2,
        use_fixed_iterations=True)
    cfg.outer.tolerance = 3e-5
    cfg.outer.reduction = 1e-5
    return cfg


def stokes_config(pair, spacedim=2):
    """The results table's Stokes configuration
    (scripts/make_results_table.py:88-124): IBStokesAL, grad-div,
    W = diag(M_Γ)⁻², outer tolerance 3e-4 and reduction 1e-5, at background
    and immersed refinements ``pair`` ("9:10"); in 3D the sphere with
    g = (-1, 1, 0), body force (1, 0, 0) and Dirichlet on all six faces."""
    from fictitious_domain_al_preconditioners_torch.models.stokes import (
        ALControl, StokesConfig)

    ref, eref = (int(x) for x in pair.split(":"))
    cfg = StokesConfig(spacedim=spacedim, initial_refinement=ref,
                       initial_embedded_refinement=eref,
                       al=ALControl(grad_div_stabilization=True,
                                    inverse_diag_square=True))
    if spacedim == 3:
        cfg.dirichlet_ids = (0, 1, 2, 3, 4, 5)
        cfg.body_force = ("1;0;0", "")
        cfg.dirichlet_bc = ("0;0;0", "")
        cfg.embedded_value = ("-1;1;0", "")
    cfg.outer.tolerance = 3e-4
    cfg.outer.reduction = 1e-5
    return cfg


def al_form_config(refinement, form):
    """The flagship's configuration in one of the augmented solver's other
    AL forms (:data:`AL_FORMS`): ``exactw`` is the operator form with
    W = M, ``explicit`` and ``explicit_exactw`` the explicit form with
    W = diag(M)² and W = M²."""
    cfg = flagship_config(refinement)
    cfg.use_operator_form, cfg.use_diagonal_inverse = AL_FORMS[form]
    return cfg


def nitsche_config():
    """The results table's nitsche configuration
    (scripts/make_results_table.py:193-219): the manufactured solution
    u = sin(πx)sin(πy), initial refinement 4, outer tolerance 1e-8."""
    from fictitious_domain_al_preconditioners_torch.models import \
        NitscheConfig

    return NitscheConfig(use_manufactured_solution=True)


def elasticity_config(small=False):
    """The results table's elasticity configuration
    (scripts/make_results_table.py:222-246): 3D, fixed inner iterations,
    W = M² exact, outer tolerance 3e-5 and reduction 1e-5, background
    refinement 3 and immersed 2 at cycle 0; ``small``: background 2 and
    immersed 1 (tests/test_elasticity.py's smallest row)."""
    from fictitious_domain_al_preconditioners_torch.models import \
        ElasticityInterfaceConfig

    cfg = ElasticityInterfaceConfig(use_fixed_iterations=True)
    if small:
        cfg.initial_background_refinement = 2
        cfg.initial_immersed_refinement = 1
    cfg.outer.tolerance = 3e-5
    cfg.outer.reduction = 1e-5
    return cfg


def exact_solution(p):
    return np.sin(2 * np.pi * p[:, 0]) * np.sin(2 * np.pi * p[:, 1])


def cuda_time_ms(fn, reps=20, warmup=3):
    """Median over ``reps`` single calls, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_time_turns(fns, reps=20):
    """Median ms of each function of ``fns``, every one timed forward and
    then backward through the list (``reps // 2`` CUDA-event timed calls a
    turn), so that a drift of the card's clocks falls on all alike."""
    turns = [[] for _ in fns]
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        turns[i].append(cuda_time_ms(fns[i], reps // 2))
    return [statistics.median(t) for t in turns]


def graph_time_ms(fn, launches=20, reps=7):
    """Device ms of one call of ``fn`` inside a CUDA graph of ``launches``
    calls (median of ``reps`` replays): the host's launch cost, which
    outweighs a kernel on a small lattice, stays out of it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_time_ms(graph.replay, reps, warmup=2) / launches


def graph_time_turns(fns):
    """:func:`graph_time_ms` of each function of ``fns``, forward and then
    backward through the list; the mean of each one's two times."""
    turns = [[] for _ in fns]
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        turns[i].append(graph_time_ms(fns[i]))
    return [statistics.mean(t) for t in turns]


def flagship_planes(refinement, device):
    """Patch planes (5, pr, pc) and box of the flagship coupling at
    ``refinement`` (its fine level)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.core import (
        GridSpace, UniformGrid, parametrized_curve)
    from fictitious_domain_al_preconditioners_torch.ops.coupling import \
        build_coupling
    from fictitious_domain_al_preconditioners_torch.utils import \
        ParsedFunction

    cfg = flagship_config(refinement)
    conf = ParsedFunction(*cfg.embedded_configuration)
    curve = parametrized_curve(lambda p: np.asarray(conf(p)), refinement)
    space = GridSpace.q(UniformGrid.hyper_cube(2, 0.0, 1.0, refinement), 1)
    coupling = build_coupling(space, curve.space(1), 3, device="cpu")
    box, w9 = coupling.patch_w9(space, cfg.gamma / curve.h_max)
    planes = np.stack([w9[a, b] for a, b in
                       ((1, 1), (1, 2), (2, 1), (2, 2), (2, 0))])
    return torch.as_tensor(planes, dtype=torch.float32, device=device), box


def record(errs, kernel, mode, tag, got, ref):
    """Append ``(kernel, mode, tag, abs_err, rel_err)`` of one comparison
    and fail above the kernel's tolerance."""
    import torch

    got, ref = got.double(), ref.double()
    check(bool(torch.isfinite(got).all()), f"{kernel}:{mode} {tag}: "
          "non-finite output")
    abs_err = float((got - ref).abs().max())
    rel = abs_err / max(float(ref.abs().max()), 1e-300)
    errs.append((kernel, mode, tag, abs_err, rel))
    tol = (BF16_SWEEP_TOL if mode.endswith(":bf16")
           else TOL[kernel if mode == "-" else mode.split(":")[0]])
    check(rel <= tol, f"{kernel}:{mode} {tag}: rel err {rel:.3e} > tol")


def compare_stencils(h, shape, device, seed, tag, errs):
    """K1 (float32 and bf16) and K6 against their plain versions on one
    lattice."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    u = torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                        dtype=torch.float32, device=device)
    record(errs, "masked_laplace_2d", "-", tag, K.masked_laplace_2d(u, h),
           K.masked_laplace_2d_plain(u, h))
    compare_k1_bf16(h, u, tag, errs)
    record(errs, "laplace_stencil_2d", "-", tag, K.laplace_stencil_2d(u, h),
           K.laplace_stencil_2d_plain(u, h))
    compare_k6(u.double(), h, tag, errs)


def compare_k1_bf16(h, u, tag, errs):
    """K1's bf16-storage form against its plain version on ``u`` rounded to
    bf16."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    ub = u.to(torch.bfloat16)
    got = K.masked_laplace_2d(ub, h)
    check(got.dtype == torch.bfloat16, f"K1 bf16 {tag}: returned {got.dtype}")
    record(errs, "masked_laplace_2d:bf16", "-", tag, got,
           K.masked_laplace_2d_plain(ub, h))


def k1_edge_shapes():
    """Lattices at the edges of K1's tile: the coarsest levels, lattices
    shorter than a thread's run, narrower than a warp or without interior,
    rows of 30 k +- 1 points, and an even and an odd row length on each side
    of a multiple of the block's tile, for a small, a middle and a large
    lattice (the launch's three plans; the bf16 form's tile on the large
    one, which holds two of the float32 form's)."""
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    shapes = [(5, 5), (9, 9), (17, 17), (1, 7), (2, 40), (3, 3), (5, 200),
              (300, 3), (40, 2), (3, 50000), (17, 29), (17, 31), (33, 59),
              (33, 61)]
    for ny0, nx0 in ((64, 240), (512, 600), (2240, 2160)):
        tile = K.masked_laplace_tile(ny0, nx0, bf16=True)
        ty, tx = tile["run_rows"], tile["tile_columns"]
        ky, kx = max(ny0 // ty, 1), max(nx0 // tx, 1)
        shapes += [(ky * ty + dy, kx * tx + dx)
                   for dy, dx in ((-1, -2), (-1, -1), (0, 0), (1, 1), (1, 2))]
    return shapes


def compare_k1_edges(device, errs):
    """K1's two forms against the plain version at :func:`k1_edge_shapes`;
    the boundary rows and columns must equal the input bit for bit and the
    input must be left as it was."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    shapes = k1_edge_shapes()
    for i, shape in enumerate(shapes):
        h = tuple(1.0 / max(n - 1, 1) for n in shape)
        u32 = torch.as_tensor(
            np.random.default_rng(600 + i).standard_normal(shape),
            dtype=torch.float32, device=device)
        for u, name, bits in ((u32, "masked_laplace_2d", torch.int32),
                              (u32.to(torch.bfloat16),
                               "masked_laplace_2d:bf16", torch.int16)):
            tag = f"edge {shape}"
            kept = u.clone()
            got = K.masked_laplace_2d(u, h)
            torch.cuda.synchronize(device)
            check(got.dtype == u.dtype and got.shape == u.shape,
                  f"{name} {tag}: returned {got.dtype} {tuple(got.shape)}")
            check(torch.equal(u.view(bits), kept.view(bits)),
                  f"{name} {tag}: the input was changed")
            record(errs, name, "-", tag, got, K.masked_laplace_2d_plain(u, h))
            for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
                check(torch.equal(got[edge].contiguous().view(bits),
                                  u[edge].contiguous().view(bits)),
                      f"{name} {tag}: boundary differs from the input")
    print(f"phase 2: K1 float32 and bf16 agree with plain at {len(shapes)} "
          "edge shapes", flush=True)


def window_edge_shapes():
    """Lattices at the edges of the window kernels' tile (K6, the patched K2
    ``op``): the coarsest levels, lattices shorter than a thread's run or
    narrower than a warp, rows of 30 k +- 1 points, and an even and an odd
    row length on each side of a multiple of the block's tile, for a small,
    a middle and a large lattice (the launch's three plans)."""
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    shapes = [(3, 3), (5, 5), (9, 9), (17, 17), (2, 40), (40, 2), (3, 40),
              (5, 200), (300, 3), (3, 50000), (17, 29), (17, 31), (33, 59),
              (33, 61)]
    for ny0, nx0 in ((64, 240), (512, 600), (2240, 2160)):
        tile = K.window_plan(ny0, nx0)
        ty, tx = tile["run_rows"], tile["tile_columns"]
        ky, kx = ny0 // ty, nx0 // tx
        shapes += [(ky * ty + dy, kx * tx + dx)
                   for dy, dx in ((-1, -2), (-1, -1), (0, 0), (1, 1), (1, 2))]
    return shapes


def op_edge_cases():
    """(lattice, patch box) pairs at the edges of the patched K2 ``op``'s
    tile: for each of the launch's three plans a lattice one point short of
    and one point over a multiple of the block's tile, with boxes whose
    first and last row and column are a run's first and last row and a
    warp's first and last kept column, the same boxes shifted onto the
    neighbouring run and warp, the whole interior (the lattice border less
    one), the whole lattice, and boxes of one point inside and in the last
    interior corner; and the coarse levels 3², 5², 9², 17²."""
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    keep = K.WINDOW_KEEP
    cases = []
    for ny0, nx0 in ((64, 240), (512, 600), (2240, 2160)):
        run = K.window_plan(ny0, nx0)["run_rows"]
        for d in (-1, 1):
            ny, nx = ny0 + d, nx0 + d
            cases += [((ny, nx), box) for box in (
                (2 * run, 2 * keep, 3 * run, 4 * keep),
                (3 * run - 1, 3 * keep - 1, 2 * run + 2, 2 * keep + 2),
                (1, 1, ny - 2, nx - 2), (0, 0, ny, nx),
                (2 * run, 2 * keep, 1, 1), (ny - 2, nx - 2, 1, 1))]
    for n in (3, 5, 9, 17):
        cases += [((n, n), box) for box in (
            (0, 0, n, n), (1, 1, n - 2, n - 2), (n // 2, n // 2, 1, 1))]
    return list(dict.fromkeys(cases))


def random_patch_stencil(shape, box, device, seed):
    """An :class:`AugmentedStencil2D` on ``shape`` whose planes on ``box``
    are uniform in [0.1, 1) (of the size of the stiffness weights)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    planes = np.random.default_rng(seed).uniform(
        0.1, 1.0, (5,) + tuple(box[2:])).astype(np.float32)
    h = tuple(1.0 / max(n - 1, 1) for n in shape)
    return K.AugmentedStencil2D(h, shape,
                                torch.as_tensor(planes, device=device), box)


def compare_k6(u, h, tag, errs):
    """K6 in ``u``'s dtype form against its plain version on ``u``; the
    input must be left as it was."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    name = ("laplace_stencil_2d:f64" if u.dtype == torch.float64
            else "laplace_stencil_2d")
    kept = u.clone()
    got = K.laplace_stencil_2d(u, h)
    torch.cuda.synchronize(u.device)
    check(got.dtype == u.dtype and got.shape == u.shape,
          f"{name} {tag}: returned {got.dtype} {tuple(got.shape)}")
    check(torch.equal(u, kept), f"{name} {tag}: the input was changed")
    record(errs, name, "-", tag, got, K.laplace_stencil_2d_plain(u, h))


def compare_k6_edges(device, errs):
    """K6's two forms against the plain version at
    :func:`window_edge_shapes`."""
    import torch

    shapes = window_edge_shapes()
    for i, shape in enumerate(shapes):
        h = tuple(1.0 / max(n - 1, 1) for n in shape)
        u = torch.as_tensor(
            np.random.default_rng(700 + i).standard_normal(shape),
            dtype=torch.float64, device=device)
        for v in (u.float(), u):
            compare_k6(v, h, f"edge {shape}", errs)
    print(f"phase 2: K6 float32 and float64 agree with plain at {len(shapes)} "
          "edge shapes", flush=True)


def compare_op_edges(device, errs):
    """The patched K2 ``op`` against the plain version at
    :func:`op_edge_cases`; the boundary rows and columns must equal the
    input bit for bit and the input must be left as it was."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    cases = op_edge_cases()
    for i, (shape, box) in enumerate(cases):
        st = random_patch_stencil(shape, box, device, seed=800 + i)
        b = torch.as_tensor(
            np.random.default_rng(900 + i).standard_normal(shape),
            dtype=torch.float32, device=device)
        kept = b.clone()
        got = K.fused_augmented_2d("op", st, b)
        torch.cuda.synchronize(device)
        tag = f"edge {shape} box {box}"
        check(got.dtype == b.dtype and got.shape == b.shape,
              f"op {tag}: returned {got.dtype} {tuple(got.shape)}")
        check(torch.equal(b.view(torch.int32), kept.view(torch.int32)),
              f"op {tag}: the input was changed")
        record(errs, "fused_augmented_2d", "op", tag, got,
               K.fused_augmented_2d_plain("op", st, b))
        for edge in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
            check(torch.equal(got[edge].contiguous().view(torch.int32),
                              b[edge].contiguous().view(torch.int32)),
                  f"op {tag}: boundary differs from the input")
    print(f"phase 2: the patched K2 op agrees with plain at {len(cases)} "
          "edge cases", flush=True)


def compare_fused(st, device, lam, seed, tag, errs):
    """K2 in all four modes against its plain version on one stencil (with
    or without patch planes), in the stencil's dtype: a bf16 stencil runs
    the bf16-storage kernel on bf16 vectors, held to the float32 plain form
    on the same inputs (:data:`BF16_SWEEP_TOL`)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                        device=device).to(st.dtype)
    x0 = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                         device=device).to(st.dtype)
    kw = dict(lam_max=lam, degree=4, eig_ratio=30.0)
    bf16 = st.dtype == torch.bfloat16
    form = ("" if st.patched else ":no_patch") + (":bf16" if bf16 else "")
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        got = K.fused_augmented_2d(mode, st, b, xin, **kw)
        ref = K.fused_augmented_2d_plain(
            mode, st.float32, b.float(),
            None if xin is None else xin.float(), **kw)
        pairs = zip(got, ref) if mode == "pre" else [(got, ref)]
        for g, r in pairs:
            check(g.dtype == st.dtype, f"K2 {mode}{form} {tag}: returned "
                  f"{g.dtype}")
            record(errs, "fused_augmented_2d", mode + form, tag, g, r)


def stencil_lam(st):
    """Lanczos bound of D⁻¹A for a stencil (plain operator)."""
    from fictitious_domain_al_preconditioners_torch.ops.krylov import \
        lanczos_max_eig

    shape = st.shape

    def mv(v):
        return (st.dinv * st.op_plain(v.reshape(shape))).reshape(-1)

    return lanczos_max_eig(mv, shape[0] * shape[1], steps=10,
                           dtype=st.dtype, device=st.device)


def phase_kernels(device):
    import torch
    from fictitious_domain_al_preconditioners_torch.ops.kernels import (
        AugmentedStencil2D, sweep_output_tile)

    errs = []
    compare_k1_edges(device, errs)
    compare_k6_edges(device, errs)
    compare_op_edges(device, errs)
    cases = []
    for ref in (6, 10):                       # n = 65, 1025
        planes, box = flagship_planes(ref, device)
        n = 2 ** ref + 1
        cases.append((f"n={n}", (n, n), planes, box))
    # non-square and not a multiple of any tile; the box origin sits on a
    # tile edge of the degree-4 pre/post kernels (24 x 88 output tiles)
    planes, (_, _, pr, pc) = flagship_planes(9, device)
    ty, tx = sweep_output_tile("pre", 4)
    cases.append(("(530,777)", (530, 777), planes, (2 * ty, tx, pr, pc)))
    for i, (tag, shape, planes, box) in enumerate(cases):
        h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
        compare_stencils(h, shape, device, seed=i, tag=tag, errs=errs)
        for st in (AugmentedStencil2D(h, shape, planes, box),
                   AugmentedStencil2D(h, shape, device=device,
                                      dtype=planes.dtype),
                   AugmentedStencil2D(h, shape, planes.to(torch.bfloat16),
                                      box),
                   AugmentedStencil2D(h, shape, device=device,
                                      dtype=torch.bfloat16)):
            lam = stencil_lam(st.float32)
            compare_fused(st, device, lam, seed=10 + i, tag=tag, errs=errs)
            print(f"phase 2: {tag} box={st.box} lam_max={lam:.6f} ok",
                  flush=True)
    return errs


def drive(prob_factory, device):
    """Set the launch counts to 0, set up, run a warm-up and a timed solve,
    read the counts, check the result; return ``(prob, out)``."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    prob = prob_factory().setup()
    setup_s = time.perf_counter() - t0
    prob.solve()                                          # warm-up
    warm = dict(prob.results)
    u, _, _ = prob.solve()                                # timed
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    res = prob.results
    dofs = prob.space.n_dofs
    out = dict(
        solver=prob.cfg.solver, refinement=prob.cfg.initial_refinement,
        dofs_background=dofs, dofs_immersed=prob.imm_space.n_dofs,
        setup_seconds=setup_s, build_seconds=warm["build_seconds"],
        warmup_solve_seconds=warm["solve_seconds"],
        warmup_outer_iterations=warm["outer_iterations"],
        outer_iterations=res["outer_iterations"],
        converged=res["converged"], residual=res["residual"],
        constraint_residual=prob.constraint_residual(),
        solve_seconds=res["solve_seconds"],
        mdof_iter_per_s=dofs * max(res["outer_iterations"], 1)
        / res["solve_seconds"] / 1e6,
        host_syncs=res["host_syncs"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
        launches=launches)
    tag = f"{prob.cfg.solver}@{prob.cfg.initial_refinement}"
    check(res["converged"], f"{tag}: solve did not converge (residual "
          f"{res['residual']:.3e})")
    check(math.isfinite(out["constraint_residual"]),
          f"{tag}: constraint residual not finite")
    check(tuple(u.shape) == (dofs,) and bool(torch.isfinite(u).all()),
          f"{tag}: solution has the wrong shape or non-finite values")
    return prob, out


def require_launches(out, keys, tag):
    for key in keys:
        check(out["launches"].get(key, 0) > 0, f"{tag}: {key} never launched")


def phase_flagship(refinement, device):
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops.kernels import \
        launch_key

    prob, out = drive(lambda: ImmersedLaplaceProblem(
        flagship_config(refinement), device=device), device)
    print("phase 3: " + json.dumps(out), flush=True)
    require_launches(out, ["masked_laplace_2d", "laplace_stencil_2d"]
                     + [launch_key(m) for m in ("op", "pre", "post")],
                     "phase 3")
    return prob, out


def phase_flagship_shapes(prob, device, phase="phase 3"):
    """Every kernel against its plain version at the shapes the flagship
    path gave it, with that path's planes and Lanczos bounds."""
    errs = []
    for i, (level, st) in enumerate(zip(prob._last_gmg.levels,
                                        prob.level_stencils)):
        lat = tuple(reversed(level.space.n_points_1d))
        h = tuple(1.0 / (n - 1) for n in lat)
        compare_stencils(h, lat, device, seed=100 + i,
                         tag=f"flagship level {i} {lat}", errs=errs)
        if st is not None:
            compare_fused(st, device, level.lam_max, seed=200 + i,
                          tag=f"flagship level {i} {lat}", errs=errs)
    print(f"{phase}: kernels agree with plain at all {len(errs)} "
          "path comparisons", flush=True)
    return errs


def phase_mode(solver, refinement, device):
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops.kernels import \
        launch_key

    prob, out = drive(lambda: ImmersedLaplaceProblem(
        mode_config(solver, refinement), device=device), device)
    print("phase 5: " + json.dumps(out), flush=True)
    require_launches(out, ["masked_laplace_2d", "laplace_stencil_2d"]
                     + [launch_key(m, False) for m in ("pre", "post")],
                     f"phase 5 {solver}")
    errs = []
    for i, (level, st) in enumerate(zip(prob._kinv_gmg.levels,
                                        prob.kinv_stencils)):
        tag = f"{solver} K_inv level {i} {st.shape}"
        compare_stencils(st.h, st.shape, device, seed=300 + i, tag=tag,
                         errs=errs)
        compare_fused(st, device, level.lam_max, seed=400 + i, tag=tag,
                      errs=errs)
    print(f"phase 5: {solver}: kernels agree with plain at all {len(errs)} "
          "path comparisons", flush=True)
    return prob, out, errs


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take,
    bytes over the memory rate against operations over the f32 (or the
    given) rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_bound(mode, st, degree, itemsize=4):
    """Bound of one K2 call: the lattice inputs read once (b, and x0 in
    post), the outputs written once (x, and r in pre), the planes read once,
    each value ``itemsize`` bytes (2 in bf16 storage); the stencil
    applications, Chebyshev updates and patch terms done (float32)."""
    ny, nx = st.shape
    n = ny * nx
    box = st.box[2] * st.box[3]
    arrays = {"op": 2, "smooth": 2, "pre": 3, "post": 3}[mode]
    apps = {"op": 1, "smooth": degree - 1, "pre": degree,
            "post": degree}[mode]
    updates = 0 if mode == "op" else degree - 1
    nbytes = itemsize * (arrays * n + 5 * box)
    flops = n * (apps * STENCIL_FLOPS + 6 * updates + 4) + box * apps * 18
    return bound(nbytes, flops)


def time_fused(st, lam, degree, device, times):
    """K2's modes at one stencil, in its dtype (a bf16 stencil's keys end in
    ``:bf16``): kernel and plain times between CUDA events (``ms`` holds the
    host's cost of one wrapper call), the kernel's device ms a launch in a
    CUDA graph (``graph_ms``), and the bound."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    rng = np.random.default_rng(7)
    b = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                        device=device).to(st.dtype)
    x0 = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                         device=device).to(st.dtype)
    kw = dict(lam_max=lam, degree=degree, eig_ratio=30.0)
    form = (("" if st.patched else ":no_patch")
            + (":bf16" if st.dtype == torch.bfloat16 else ""))
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        ms, pms = cuda_time_turns(
            [lambda: K.fused_augmented_2d(mode, st, b, xin, **kw),
             lambda: K.fused_augmented_2d_plain(mode, st, b, xin, **kw)])
        gms = graph_time_ms(
            lambda: K.fused_augmented_2d(mode, st, b, xin, **kw))
        times[mode + form] = dict(ms=ms, plain_ms=pms, library_ms=None,
                                  graph_ms=gms, shape=list(st.shape))
        times[mode + form]["bound_ms"], times[mode + form]["bound_by"] = \
            fused_bound(mode, st, degree, st.dtype.itemsize)


def time_k2_rows(refinement, device):
    """K2's modes in float32 and in bf16 storage at the fine lattice of
    ``refinement`` with the flagship's planes and a Lanczos bound of the
    float32 stencil (:func:`time_fused`'s rows, keyed as there)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops.kernels import \
        AugmentedStencil2D

    planes, box = flagship_planes(refinement, device)
    n = 2 ** refinement + 1
    h = (1.0 / (n - 1), 1.0 / (n - 1))
    st = AugmentedStencil2D(h, (n, n), planes, box)
    lam = stencil_lam(st)
    times = {}
    for s in (st, AugmentedStencil2D(h, (n, n), planes.to(torch.bfloat16),
                                     box)):
        time_fused(s, lam, 4, device, times)
    return times


def print_times(times):
    """One line a row of kernel times (``time_*``'s)."""
    for k, t in times.items():
        also = "".join(
            f", {name} {t[key]:.4f} ms" for key, name in
            (("copy_ms", "copy"), ("k2_op_ms", "no-patch K2 op"),
             ("graph_ms", "in a CUDA graph: kernel"),
             ("copy_graph_ms", "copy"),
             ("k2_op_graph_ms", "no-patch K2 op"),
             ("k1_graph_ms", "K1")) if key in t)
        print(f"time {k} at {tuple(t['shape'])}: kernel {t['ms']:.4f} "
              f"ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library "
              f"{t['library_ms']} ms{also}", flush=True)


def time_stencils(h, shape, device, times):
    """K1 and K6 at one lattice: kernel, plain and bound; K1 in the same
    turns as a device copy of the lattice (the same bytes: the ceiling of a
    streaming kernel) and the no-patch K2 ``op``, which computes the same
    function, each as a CUDA-event timed call (``ms``: it holds the host's
    cost of one wrapper call, during which the card waits) and as device ms
    a launch inside a CUDA graph (``graph_ms``); K6 likewise, in a CUDA
    graph in the same turns as the copy and K1, and against ``conv2d`` with
    its 3x3 weight and ``padding=1`` (the body of ``_conv9_pallas``, without
    the edge corrections)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    u = torch.as_tensor(np.random.default_rng(8).standard_normal(shape),
                        dtype=torch.float32, device=device)
    n = shape[0] * shape[1]
    b = bound(8 * n, STENCIL_FLOPS * n)
    dst = torch.empty_like(u)
    st = K.AugmentedStencil2D(h, shape, device=device, dtype=u.dtype)
    fns = [lambda: K.masked_laplace_2d(u, h), lambda: dst.copy_(u),
           lambda: K.fused_augmented_2d("op", st, u)]
    ms, cms, oms, pms = cuda_time_turns(
        fns + [lambda: K.masked_laplace_2d_plain(u, h)])
    gms, gcms, goms = graph_time_turns(fns)
    times["masked_laplace_2d"] = dict(
        ms=ms, plain_ms=pms, library_ms=None, bound_ms=b[0], bound_by=b[1],
        copy_ms=cms, k2_op_ms=oms, graph_ms=gms, copy_graph_ms=gcms,
        k2_op_graph_ms=goms, shape=list(shape))
    K0, M0, K1, M1 = K.stencil_factors_2d(h)
    w = torch.as_tensor(np.outer(K0, M1) + np.outer(M0, K1),
                        dtype=torch.float32, device=device)[None, None]
    ms, pms = cuda_time_turns([lambda: K.laplace_stencil_2d(u, h),
                               lambda: K.laplace_stencil_2d_plain(u, h)])
    lib = cuda_time_ms(lambda: torch.nn.functional.conv2d(
        u[None, None], w, padding=1))
    gms, gcms, gk1 = graph_time_turns(
        [lambda: K.laplace_stencil_2d(u, h), fns[1], fns[0]])
    times["laplace_stencil_2d"] = dict(
        ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b[0], bound_by=b[1],
        graph_ms=gms, copy_graph_ms=gcms, k1_graph_ms=gk1, shape=list(shape))


def time_k1_bf16(h, shape, device, times):
    """K1's bf16 form at one lattice: kernel, plain and bound (2 bytes read
    and 2 written per point; no single PyTorch call computes the masked
    stencil, so no library time)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    u = torch.as_tensor(np.random.default_rng(9).standard_normal(shape),
                        dtype=torch.float32, device=device).to(torch.bfloat16)
    n = shape[0] * shape[1]
    b = bound(4 * n, STENCIL_FLOPS * n)
    dst = torch.empty_like(u)
    fns = [lambda: K.masked_laplace_2d(u, h), lambda: dst.copy_(u)]
    ms, cms, pms = cuda_time_turns(
        fns + [lambda: K.masked_laplace_2d_plain(u, h)])
    gms, gcms = graph_time_turns(fns)
    times["masked_laplace_2d:bf16"] = dict(
        ms=ms, plain_ms=pms, library_ms=None, bound_ms=b[0], bound_by=b[1],
        copy_ms=cms, graph_ms=gms, copy_graph_ms=gcms, shape=list(shape))


def time_k1_levels(shapes, device, times):
    """K1's two forms and a device copy of the same lattice at every level
    shape: device ms a launch inside a CUDA graph (:func:`graph_time_ms`),
    so that the coarse levels, where a launch costs the host more than the
    kernel runs, are on record too.  One line a shape; the rows go into the
    kernels' entries as ``levels``."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    for name in ("masked_laplace_2d", "masked_laplace_2d:bf16"):
        times[name]["levels"] = []
    for shape in shapes:
        h = tuple(1.0 / (n - 1) for n in shape)
        u32 = torch.as_tensor(np.random.default_rng(8).standard_normal(shape),
                              dtype=torch.float32, device=device)
        row = {}
        for name, u in (("masked_laplace_2d", u32),
                        ("masked_laplace_2d:bf16", u32.to(torch.bfloat16))):
            dst = torch.empty_like(u)
            ms = graph_time_ms(lambda: K.masked_laplace_2d(u, h))
            cms = graph_time_ms(lambda: dst.copy_(u))
            n = shape[0] * shape[1]
            bms = bound(2 * u.element_size() * n, STENCIL_FLOPS * n)[0]
            row[name] = (ms, cms)
            times[name]["levels"].append(dict(shape=list(shape), ms=ms,
                                              copy_ms=cms, bound_ms=bms))
        f, b = row["masked_laplace_2d"], row["masked_laplace_2d:bf16"]
        print(f"time K1 level {shape}: float32 {f[0]:.5f} ms (copy "
              f"{f[1]:.5f}), bf16 {b[0]:.5f} ms (copy {b[1]:.5f}), in a "
              "CUDA graph", flush=True)


def time_window_levels(shapes, stencils, device, times):
    """K6 and the patched K2 ``op`` at every level shape, in the same turns
    as a device copy of the lattice and K1: device ms a launch inside a
    CUDA graph (:func:`graph_time_turns`).  ``stencils`` holds each level's
    :class:`AugmentedStencil2D` (its own patch box), or None on a level
    without one, where ``op`` is not timed.  One line a shape; the rows go
    into the kernels' entries as ``levels``, and the fine level's copy and
    K1 times into the patched ``op``'s entry."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    times["laplace_stencil_2d"]["levels"] = []
    times["op"]["levels"] = []
    for shape, st in zip(shapes, stencils):
        h = tuple(1.0 / (n - 1) for n in shape)
        u = torch.as_tensor(np.random.default_rng(8).standard_normal(shape),
                            dtype=torch.float32, device=device)
        dst = torch.empty_like(u)
        n = shape[0] * shape[1]
        fns = [lambda: K.laplace_stencil_2d(u, h), lambda: dst.copy_(u),
               lambda: K.masked_laplace_2d(u, h)]
        if st is not None:
            fns.append(lambda: K.fused_augmented_2d("op", st, u))
        ms = graph_time_turns(fns)
        times["laplace_stencil_2d"]["levels"].append(dict(
            shape=list(shape), ms=ms[0], copy_ms=ms[1], k1_ms=ms[2],
            bound_ms=bound(8 * n, STENCIL_FLOPS * n)[0]))
        line = (f"time level {shape}: K6 {ms[0]:.5f} ms, copy {ms[1]:.5f}, "
                f"K1 {ms[2]:.5f}")
        if st is not None:
            times["op"]["levels"].append(dict(
                shape=list(shape), box=list(st.box), ms=ms[3], copy_ms=ms[1],
                k1_ms=ms[2], bound_ms=fused_bound("op", st, 0)[0]))
            line += f", patched op {ms[3]:.5f} (box {st.box})"
            if list(shape) == times["op"]["shape"]:
                times["op"].update(copy_graph_ms=ms[1], k1_graph_ms=ms[2])
        print(line + ", in a CUDA graph", flush=True)


def phase_bf16_flagship(refinement, device, f32_iterations):
    """The flagship with the bf16 V-cycle: converged within 2 outer
    iterations of the float32 V-cycle's count; K2 in bf16 storage
    (``op``, ``pre``, ``post``) on the levels whose band is interior and K1
    bf16 on the others, each agreeing with its plain version at every level
    shape, K2 with the level's own planes and Lanczos bound."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops.kernels import \
        launch_key

    prob, out = drive(lambda: ImmersedLaplaceProblem(
        flagship_config(refinement, bf16=True), device=device), device)
    out["gmg_dtype"] = str(prob._last_gmg.dtype)
    out["gmg_levels"] = len(prob._last_gmg.levels)
    print("phase 6: bf16 flagship " + json.dumps(out), flush=True)
    check(prob._last_gmg.dtype == torch.bfloat16,
          "phase 6: the V-cycle is not bf16")
    check(out["outer_iterations"] <= f32_iterations + 2,
          f"phase 6: {out['outer_iterations']} outer iterations against "
          f"{f32_iterations} with the float32 V-cycle")
    require_launches(out, ["masked_laplace_2d:bf16", "laplace_stencil_2d",
                           launch_key("op")]
                     + [launch_key(m, bf16=True) for m in ("op", "pre",
                                                           "post")],
                     "phase 6")
    errs = []
    for i, (level, st) in enumerate(zip(prob._last_gmg.levels,
                                        prob.level_stencils)):
        lat = tuple(reversed(level.space.n_points_1d))
        h = tuple(1.0 / (n - 1) for n in lat)
        u = torch.as_tensor(
            np.random.default_rng(500 + i).standard_normal(lat),
            dtype=torch.float32, device=device)
        tag = f"bf16 flagship level {i} {lat}"
        compare_k1_bf16(h, u, tag, errs)
        if st is not None:
            check(st.dtype == torch.bfloat16, f"phase 6: {tag} holds a "
                  f"{st.dtype} stencil")
            compare_fused(st, device, level.lam_max, seed=520 + i, tag=tag,
                          errs=errs)
    print(f"phase 6: K1 bf16 and K2 bf16 agree with plain at all "
          f"{len(errs)} level comparisons", flush=True)
    return prob, out, errs


def phase_refined(refinement, device, bf16):
    """``solve_refined(tol_abs=1e-10)`` of the flagship: twice (the first
    builds the host system and the correction solver), launch counts over
    the second; the true float64 residual must reach the tolerance."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    tag = f"refined{'_bf16' if bf16 else ''}@{refinement}"
    torch.cuda.reset_peak_memory_stats(device)
    prob = ImmersedLaplaceProblem(flagship_config(refinement, bf16=bf16),
                                  device=device).setup()
    prob.solve_refined(tol_abs=REFINED_TOL)                  # warm-up
    warm = dict(prob.results)
    K.reset_launch_counts()
    u, lam, history = prob.solve_refined(tol_abs=REFINED_TOL)
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    res = prob.results
    out = dict(
        path=tag, refinement=refinement, gmg_dtype=str(prob._last_gmg.dtype),
        dofs_background=prob.space.n_dofs,
        dofs_immersed=prob.imm_space.n_dofs,
        refine_steps=res["refine_steps"],
        outer_iterations=res["outer_iterations"],
        converged=res["converged"], refined_residual=res["refined_residual"],
        history=history, solve_seconds=res["refined_seconds"],
        device_seconds=res["correction_seconds"],
        host_residual_seconds=res["host_residual_seconds"],
        host_syncs=res["host_syncs"],
        warmup_seconds=warm["refined_seconds"],
        build_seconds=warm["refine_build_seconds"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
        launches=launches)
    print("phase 6: " + json.dumps(out), flush=True)
    check(res["converged"] and history[-1] <= REFINED_TOL,
          f"phase 6 {tag}: true residual {history[-1]:.3e} > {REFINED_TOL}")
    check(u.shape == (prob.space.n_dofs,) and bool(np.isfinite(u).all())
          and bool(np.isfinite(lam).all()),
          f"phase 6 {tag}: non-finite or misshapen iterate")
    require_launches(out, [K.launch_key("op"), K.launch_key("pre", bf16=bf16)],
                     f"phase 6 {tag}")
    return out


def phase_elliptic(cycle, device, phase="phase 7", degrees=(1, 1)):
    """The elliptic interface problem at ``cycle``: set up, ``solve()``,
    then ``solve_refined(tol_abs=1e-10)`` on the operators the solve built;
    launch counts over the whole path.  The true float64 residual must
    reach the tolerance and K6 must have been launched; K6 is then compared
    with its plain version at every level shape of both hierarchies that
    is a Q1 lattice.  ``degrees`` are the background and immersed element
    degrees (phase 14: a Q2 side takes the element form and its flat
    GMG)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        EllipticInterfaceProblem
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K
    from fictitious_domain_al_preconditioners_torch.ops.host_ref import \
        HostEllipticSystem

    tag = f"elliptic@{cycle}" + {(1, 1): "", (2, 1): "_q2_background",
                                 (1, 2): "_q2_immersed"}[tuple(degrees)]
    cfg = elliptic_config()
    cfg.background_space_degree, cfg.immersed_space_degree = degrees
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    prob = EllipticInterfaceProblem(cfg, device=device).setup(cycle)
    setup_s = time.perf_counter() - t0
    its = prob.solve()
    solve = dict(prob.results)
    constraint = prob.constraint_residual()
    # the true float64 residual of the solve, on the host
    rs = HostEllipticSystem(prob).residual(
        *(x.double().cpu().numpy() for x in (prob.u, prob.u2, prob.lam)))
    solve_true = float(np.sqrt(sum(float(r @ r) for r in rs)))
    u, u2, lam, history = prob.solve_refined(tol_abs=REFINED_TOL)
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    res = prob.results
    parts = prob._last_parts
    out = dict(
        path=tag, cycle=cycle, degrees=list(degrees),
        dofs_background=prob.space.n_dofs,
        dofs_immersed=prob.fg_space.n_dofs,
        dofs_total=prob.layout.total, outer_iterations=its,
        converged=solve["converged"], residual=solve["residual"],
        true_residual=solve_true, constraint_residual=constraint,
        refine_steps=res["refine_steps"],
        total_outer_iterations=res["outer_iterations"],
        refined_residual=res["refined_residual"], history=history,
        refined_converged=res["converged"],
        constraint_residual_refined=prob.constraint_residual(),
        setup_seconds=setup_s, build_seconds=solve["build_seconds"],
        solve_seconds=solve["solve_seconds"],
        solve_host_syncs=solve["host_syncs"],
        refined_seconds=res["refined_seconds"],
        refine_build_seconds=res["refine_build_seconds"],
        device_seconds=res["correction_seconds"],
        host_residual_seconds=res["host_residual_seconds"],
        refined_host_syncs=res["host_syncs"],
        gmg_levels=[len(parts["gmg11"].levels), len(parts["gmg22"].levels)],
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
        launches=launches)
    print(f"{phase}: " + json.dumps(out), flush=True)
    check(solve["converged"], f"{phase} {tag}: solve did not converge "
          f"(residual {solve['residual']:.3e})")
    check(res["converged"] and history[-1] <= REFINED_TOL,
          f"{phase} {tag}: true residual {history[-1]:.3e} > {REFINED_TOL}")
    check(all(x.shape == (n,) and bool(np.isfinite(x).all())
              for x, n in zip((u, u2, lam), prob.layout.sizes)),
          f"{phase} {tag}: non-finite or misshapen iterate")
    check(math.isfinite(constraint), f"{phase} {tag}: constraint residual "
          "not finite")
    require_launches(out, ["laplace_stencil_2d", "laplace_stencil_2d:f64"],
                     f"{phase} {tag}")
    print(f"{phase}: K6 launched {launches.get('laplace_stencil_2d', 0)} "
          f"times in float32 and {launches.get('laplace_stencil_2d:f64', 0)} "
          f"in float64 on "
          f"the {tag} path", flush=True)
    errs = []
    for name in ("gmg11", "gmg22"):
        for i, level in enumerate(parts[name].levels):
            if level.space.fe.degree != 1:
                continue              # a Q2 level: element form, no K6
            lat = tuple(reversed(level.space.n_points_1d))
            h = tuple(float(x) for x in reversed(level.space.grid.h))
            v = torch.as_tensor(
                np.random.default_rng(1000 + i).standard_normal(lat),
                dtype=torch.float64, device=device)
            for x in (v.float(), v):
                compare_k6(x, h, f"elliptic {name} level {i} {lat}", errs)
    print(f"{phase}: K6 float32 and float64 agree with plain at all "
          f"{len(errs)} level comparisons", flush=True)
    return out, errs, prob.space


def time_k6_f64(space, device, times):
    """K6's float64 form at the lattice of ``space`` (the elliptic fine
    background): kernel, plain and bound (8 bytes read and 8 written per
    point, 30 operations at the float64 rate), against ``conv2d`` in float64
    with the 3x3 weight and ``padding=1`` (the body without the edge
    corrections), and as device ms a launch in a CUDA graph beside a float64
    device copy of the lattice."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    shape = tuple(reversed(space.n_points_1d))
    h = tuple(float(x) for x in reversed(space.grid.h))
    u = torch.as_tensor(np.random.default_rng(10).standard_normal(shape),
                        dtype=torch.float64, device=device)
    n = shape[0] * shape[1]
    b = bound(16 * n, STENCIL_FLOPS * n, F64_FLOP_PER_S)
    K0, M0, K1, M1 = K.stencil_factors_2d(h)
    w = torch.as_tensor(np.outer(K0, M1) + np.outer(M0, K1),
                        dtype=torch.float64, device=device)[None, None]
    ms, pms = cuda_time_turns([lambda: K.laplace_stencil_2d(u, h),
                               lambda: K.laplace_stencil_2d_plain(u, h)])
    lib = cuda_time_ms(lambda: torch.nn.functional.conv2d(
        u[None, None], w, padding=1))
    dst = torch.empty_like(u)
    gms, gcms = graph_time_turns([lambda: K.laplace_stencil_2d(u, h),
                                  lambda: dst.copy_(u)])
    times["laplace_stencil_2d:f64"] = dict(
        ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b[0], bound_by=b[1],
        graph_ms=gms, copy_graph_ms=gcms, shape=list(shape))
    print(f"time laplace_stencil_2d:f64 at {shape}: kernel {ms:.4f} ms, "
          f"plain {pms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), library "
          f"{lib:.4f} ms, in a CUDA graph: kernel {gms:.4f} ms, copy "
          f"{gcms:.4f} ms", flush=True)


def phase_elliptic_crosscheck(device, cycle=ELLIPTIC_CROSSCHECK_CYCLE):
    """The elliptic problem at ``cycle`` on the card and on the CPU, both
    with float32 V-cycles (``dtype``; the operator and the Krylov solvers
    are float64 on both): outer counts within 1, and each of the three
    solution blocks (u, u₂, λ) within 1e-3 of its max |CPU value|."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        EllipticInterfaceProblem

    runs = {}
    for dev in (device, torch.device("cpu")):
        prob = EllipticInterfaceProblem(elliptic_config(), device=dev,
                                        dtype=torch.float32).setup(cycle)
        its = prob.solve()
        x = [b.cpu().double() for b in (prob.u, prob.u2, prob.lam)]
        runs[dev.type] = (x, its, prob.results["converged"])
    (xg, itg, cg_), (xc, itc, cc) = runs["cuda"], runs["cpu"]
    diffs = [float((g - c).abs().max()) for g, c in zip(xg, xc)]
    scales = [float(c.abs().max()) for c in xc]
    out = dict(path=f"elliptic@{cycle}", iterations_gpu=itg,
               iterations_cpu=itc, converged=(cg_, cc),
               max_abs_diff=diffs, max_abs_cpu=scales)
    print("phase 4: " + json.dumps(out), flush=True)
    check(cg_ and cc, "phase 4 elliptic: a solve did not converge")
    check(abs(itg - itc) <= 1, f"phase 4 elliptic: outer counts {itg} vs "
          f"{itc}")
    for name, d, sc in zip(("u", "u2", "lambda"), diffs, scales):
        check(d <= 1e-3 * sc, f"phase 4 elliptic: |{name}_gpu - {name}_cpu| "
              f"= {d:.3e} > 1e-3 * {sc:.3e}")
    return out


def phase_crosscheck(device, refinement=7):
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops.assembly import \
        l2_error

    outs = []
    for solver in (("augmented",) + MODE_SOLVERS + ("augmented_bf16",)
                   + tuple(AL_FORMS)):
        runs = {}
        for dev in (device, torch.device("cpu")):
            if solver in AL_FORMS:
                cfg = al_form_config(refinement, solver)
            elif solver.startswith("augmented"):
                cfg = flagship_config(refinement,
                                      bf16=solver.endswith("bf16"))
            else:
                cfg = mode_config(solver, refinement)
            prob = ImmersedLaplaceProblem(cfg, device=dev,
                                          dtype=torch.float32).setup()
            u, _, info = prob.solve()
            runs[dev.type] = (u.cpu().double(), int(info.iterations),
                              bool(info.converged), prob)
        ug, itg, cg_, pg = runs["cuda"]
        uc, itc, cc, _ = runs["cpu"]
        diff = float((ug - uc).abs().max())
        scale = float(uc.abs().max())
        out = dict(solver=solver, refinement=refinement, iterations_gpu=itg,
                   iterations_cpu=itc, converged=(cg_, cc),
                   max_abs_diff=diff, max_abs_cpu=scale)
        if solver.startswith("augmented") or solver in AL_FORMS:
            out["l2_error_gpu"] = l2_error(pg.space, ug, exact_solution)
        print("phase 4: " + json.dumps(out), flush=True)
        check(cg_ and cc, f"phase 4 {solver}: a solve did not converge")
        check(abs(itg - itc) <= 1, f"phase 4 {solver}: outer counts {itg} "
              f"vs {itc}")
        check(diff <= 1e-3 * scale, f"phase 4 {solver}: |u_gpu - u_cpu| = "
              f"{diff:.3e}")
        if "l2_error_gpu" in out:
            check(out["l2_error_gpu"] < 6e-3,
                  f"phase 4: L2 error {out['l2_error_gpu']:.3e}")
        outs.append(out)
    return outs


def phase_stokes(pair, spacedim, device, delta_refinement=0):
    """The Stokes problem at ``pair``: set up, in 2D ``solve()``, then
    ``solve_refined(tol_abs=1e-8)`` (on the operators the solve built);
    launch counts over the whole path.  The true float64 residual must
    reach the tolerance; the solution must be finite.  With
    ``delta_refinement`` (phase 13) the background is refined that many
    steps near Γ and no kernel may be launched."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        StokesProblem
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K
    from fictitious_domain_al_preconditioners_torch.ops.host_ref import \
        HostStokesSystem

    tag = f"stokes{'3d' if spacedim == 3 else ''}@{pair}"
    phase = "phase 8"
    cfg = stokes_config(pair, spacedim)
    if delta_refinement:
        tag = f"adaptive_{tag}+{delta_refinement}"
        phase = "phase 13"
        cfg.delta_refinement = delta_refinement
    gc.collect()        # an earlier problem's cycles hold device memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    prob = StokesProblem(cfg, device=device).setup()
    setup_s = time.perf_counter() - t0
    solve = {}
    if spacedim == 2:
        prob.solve()
        solve = dict(prob.results)
        rs = HostStokesSystem(prob).residual(
            *(x.double().cpu().numpy() for x in (prob.u, prob.p, prob.lam)))
        solve["true_residual"] = float(np.sqrt(sum(float(r @ r)
                                                   for r in rs)))
    u, p, lam, history = prob.solve_refined(tol_abs=STOKES_TOL)
    launches = ({k: v for k, v in K.LAUNCHES.items() if v}
                if not delta_refinement else _no_launches(f"{phase} {tag}"))
    res = prob.results
    sizes = prob.layout.sizes
    out = dict(
        path=tag, spacedim=spacedim,
        dofs_velocity=sizes[0], dofs_pressure=sizes[1],
        dofs_immersed=sizes[2], dofs_total=prob.layout.total,
        setup_seconds=setup_s,
        build_seconds=res.get("build_seconds", res["refine_build_seconds"]),
        solve_outer_iterations=solve.get("outer_iterations"),
        solve_converged=solve.get("converged"),
        solve_residual=solve.get("residual"),
        solve_true_residual=solve.get("true_residual"),
        solve_seconds=solve.get("solve_seconds"),
        solve_host_syncs=solve.get("host_syncs"),
        refine_steps=res["refine_steps"],
        total_outer_iterations=res["outer_iterations"],
        refined_residual=res["refined_residual"], history=history,
        refined_converged=res["converged"],
        refined_seconds=res["refined_seconds"],
        refine_build_seconds=res["refine_build_seconds"],
        device_seconds=res["correction_seconds"],
        host_residual_seconds=res["host_residual_seconds"],
        refined_host_syncs=res["host_syncs"],
        constraint_residual=prob.constraint_residual(),
        divergence_residual=prob.divergence_residual(),
        gmg_levels=len(prob._parts["gmg"].levels),
        gmg_routes=res["gmg_routes"],
        peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
        launches=launches)
    if delta_refinement:
        out.update(cells=prob.grid.n_cells, max_level=prob.grid.max_level,
                   constrained_cells=prob.vel_space.n_constrained_cells)
    print(f"{phase}: " + json.dumps(out), flush=True)
    if spacedim == 2:
        check(solve["converged"], f"{phase} {tag}: solve did not converge "
              f"(residual {solve['residual']:.3e})")
    check(res["converged"] and history[-1] <= STOKES_TOL,
          f"{phase} {tag}: true residual {history[-1]:.3e} > {STOKES_TOL}")
    check(all(x.shape == (n,) and bool(np.isfinite(x).all())
              for x, n in zip((u, p, lam), sizes)),
          f"{phase} {tag}: non-finite or misshapen iterate")
    check(math.isfinite(out["constraint_residual"])
          and math.isfinite(out["divergence_residual"]),
          f"{phase} {tag}: constraint or divergence residual not finite")
    return out


def phase_stokes_crosscheck(device, pair=STOKES_CROSSCHECK):
    """The Stokes problem at ``pair`` on the card and on the CPU, both with
    float32 V-cycles (``dtype``; the operator and the Krylov solvers are
    float64 on both): outer counts within 1, and each of the three solution
    blocks (u, p, λ) within 1e-3 of its max |CPU value|."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        StokesProblem

    runs = {}
    for dev in (device, torch.device("cpu")):
        prob = StokesProblem(stokes_config(pair), device=dev,
                             dtype=torch.float32).setup()
        prob.solve()
        x = [b.cpu().double() for b in (prob.u, prob.p, prob.lam)]
        runs[dev.type] = (x, prob.results["outer_iterations"],
                          prob.results["converged"])
    (xg, itg, cg_), (xc, itc, cc) = runs["cuda"], runs["cpu"]
    diffs = [float((g - c).abs().max()) for g, c in zip(xg, xc)]
    scales = [float(c.abs().max()) for c in xc]
    out = dict(path=f"stokes@{pair}", iterations_gpu=itg,
               iterations_cpu=itc, converged=(cg_, cc),
               max_abs_diff=diffs, max_abs_cpu=scales)
    print("phase 4: " + json.dumps(out), flush=True)
    check(cg_ and cc, "phase 4 stokes: a solve did not converge")
    check(abs(itg - itc) <= 1, f"phase 4 stokes: outer counts {itg} vs "
          f"{itc}")
    for name, d, sc in zip(("u", "p", "lambda"), diffs, scales):
        check(d <= 1e-3 * sc, f"phase 4 stokes: |{name}_gpu - {name}_cpu| "
              f"= {d:.3e} > 1e-3 * {sc:.3e}")
    return out


def phase_al_forms(refinement, explicit_refinement, device):
    """Phase 9: the augmented solver's exact-W operator form at
    ``refinement`` (the flagship's lattice path: K2 and K1) and its two
    explicit forms (K1 and the masked compact AL block on every level) at
    ``explicit_refinement``, whose fine compact block must form within
    :data:`COMPACT_SETUP_LIMIT_S`; a warm-up and a timed solve each.  Every
    kernel of each path is compared with its plain version at that path's
    level shapes.  Returns ``(outs, errs)``."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops.kernels import \
        launch_key

    outs, errs = [], []
    for form in AL_FORMS:
        ref = refinement if form == "exactw" else explicit_refinement
        gc.collect()
        torch.cuda.empty_cache()
        prob, out = drive(lambda: ImmersedLaplaceProblem(
            al_form_config(ref, form), device=device), device)
        blocks = prob.compact_blocks
        fine = blocks[0] if blocks and form != "exactw" else None
        check(fine is None or fine["seconds"] <= COMPACT_SETUP_LIMIT_S,
              f"phase 9 {form}@{ref}: the fine compact block took "
              f"{fine and fine['seconds']} s > {COMPACT_SETUP_LIMIT_S} s")
        out["path"] = f"{form}@{ref}"
        out["gmg_levels"] = len(prob._last_gmg.levels)
        out["compact_blocks"] = blocks
        if fine is not None:
            out.update(compact_rows=fine["rows"], compact_bytes=fine["bytes"],
                       compact_seconds=fine["seconds"])
        print("phase 9: " + json.dumps(out), flush=True)
        if form == "exactw":
            require_launches(out, ["masked_laplace_2d"] + [
                launch_key(m) for m in ("op", "pre", "post")], "phase 9")
            errs += phase_flagship_shapes(prob, device)
        else:
            require_launches(out, ["masked_laplace_2d"], f"phase 9 {form}")
            check(all(st is None for st in prob.level_stencils),
                  f"phase 9 {form}: a level has patch planes")
            compare_k1_levels(prob, device, form, errs)
        print(f"phase 9: {form}: kernels agree with plain at all "
              f"{len(errs)} path comparisons so far", flush=True)
        outs.append(out)
        del prob
    gc.collect()
    torch.cuda.empty_cache()
    return outs, errs


def compare_k1_levels(prob, device, tag, errs):
    """K1 (float32) against its plain version at every level shape of
    ``prob``'s augmented V-cycle (the explicit form's levels)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    for i, level in enumerate(prob._last_gmg.levels):
        lat = tuple(reversed(level.space.n_points_1d))
        h = tuple(1.0 / (n - 1) for n in lat)
        u = torch.as_tensor(
            np.random.default_rng(700 + i).standard_normal(lat),
            dtype=torch.float32, device=device)
        record(errs, "masked_laplace_2d", "-", f"{tag} level {i} {lat}",
               K.masked_laplace_2d(u, h), K.masked_laplace_2d_plain(u, h))


def phase_rational_table(device):
    """Phase 5's open cell: the rational mode at refinements 7-9 under the
    results table's rule (f = 0, g = 1 on the circle, tolerance 3e-5,
    reduction 1e-6), a warm-up and a timed solve each, beside the TPU's
    counts; each count must equal the JAX package's float32 count on the
    CPU within 1."""
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem

    outs = []
    for ref, (tpu, cpu) in RATIONAL_TABLE.items():
        _, out = drive(lambda: ImmersedLaplaceProblem(
            mode_config("rational", ref), device=device), device)
        out["path"] = f"rational@{ref}"
        out["tpu_outer_iterations"] = tpu
        out["reference_cpu_float32_outer_iterations"] = cpu
        print("phase 5: rational table row " + json.dumps(out), flush=True)
        check(abs(out["outer_iterations"] - cpu) <= 1,
              f"phase 5 rational@{ref}: {out['outer_iterations']} outer "
              f"iterations, the reference's float32 CPU count is {cpu}")
        outs.append(out)
    return outs


def _no_launches(tag):
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    check(not launches, f"{tag}: kernels launched on a path that has none: "
          f"{launches}")
    return launches


def phase_nitsche(device, cycles):
    """Phase 10: the nitsche problem's manufactured study, one
    ``solve_refined(tol_abs=1e-10)`` a cycle (the first call builds the
    host system and the correction solver, timed apart), the true float64
    residual to 1e-10 on every row, the L2/H1 errors and their rates, the
    inner CG iterations per outer iteration.  No kernel is on this path:
    its launch counts must stay 0.  Returns the rows."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        NitscheProblem
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    rows = []
    for cycle in cycles:
        tag = f"nitsche@{cycle}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        prob = NitscheProblem(nitsche_config(), device=device).setup(cycle)
        setup_s = time.perf_counter() - t0
        u, lam, history = prob.solve_refined(tol_abs=REFINED_TOL)
        launches = _no_launches(f"phase 10 {tag}")
        res = prob.results
        l2, h1 = prob.errors()
        out = dict(
            path=tag, cycle=cycle, dofs_bulk=res["dofs_u"],
            dofs_multiplier=res["dofs_lambda"],
            refine_steps=res["refine_steps"],
            total_outer_iterations=res["outer_its"],
            inner_cg_total=res["inner_cg_total"],
            inner_cg_per_outer=res["inner_cg_per_outer"],
            refined_residual=res["refined_residual"], history=history,
            converged=res["converged"], l2_error=l2, h1_error=h1,
            setup_seconds=setup_s,
            refine_build_seconds=res["refine_build_seconds"],
            refined_seconds=res["refined_seconds"],
            device_seconds=res["correction_seconds"],
            host_residual_seconds=res["host_residual_seconds"],
            host_syncs=res["host_syncs"],
            gmg_levels=len(prob._parts["gmg"].levels),
            peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
            launches=launches)
        if rows and rows[-1]["cycle"] == cycle - 1:
            out["l2_rate"] = math.log2(rows[-1]["l2_error"] / l2)
            out["h1_rate"] = math.log2(rows[-1]["h1_error"] / h1)
        print("phase 10: " + json.dumps(out), flush=True)
        check(res["converged"] and history[-1] <= REFINED_TOL,
              f"phase 10 {tag}: true residual {history[-1]:.3e} > "
              f"{REFINED_TOL}")
        check(all(x.shape == (n,) and bool(np.isfinite(x).all())
                  for x, n in zip((u, lam), prob.layout.sizes)),
              f"phase 10 {tag}: non-finite or misshapen iterate")
        rows.append(out)
        del prob
    study = [r for r in rows if "l2_rate" in r]
    if study:
        check(study[-1]["l2_rate"] > 1.6, "phase 10: L2 rate "
              f"{study[-1]['l2_rate']:.3f} <= 1.6 at cycle "
              f"{study[-1]['cycle']}")
    return rows


def phase_elasticity(device, cycles, phase="phase 11", degree=1):
    """Phase 11: the 3D elasticity interface problem in the results table's
    configuration, one ``solve()`` (printed first) and one
    ``solve_refined(tol_abs=1e-10)`` a cycle on the operators the solve
    built, the true float64 residual to 1e-10 on every row, the GMG
    levels' routes (band or element) of both hierarchies.  No kernel is on
    this path: its launch counts must stay 0.  ``degree`` is the
    background's element degree (phase 14: 2).  Returns the rows."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ElasticityInterfaceProblem
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    rows = []
    for cycle in cycles:
        tag = f"elasticity@{cycle}" + ("_q2_background" if degree == 2
                                       else "")
        cfg = elasticity_config()
        cfg.background_space_degree = degree
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        prob = ElasticityInterfaceProblem(cfg, device=device).setup(cycle)
        setup_s = time.perf_counter() - t0
        prob.solve()
        solve = dict(prob.results)
        print(f"{phase}: {tag} solve(): {solve['outer_iterations']} outer "
              f"iterations, converged {solve['converged']}, "
              f"{solve['solve_seconds']:.2f} s after "
              f"{solve['build_seconds']:.2f} s of build", flush=True)
        u, u2, lam, history = prob.solve_refined(tol_abs=REFINED_TOL)
        launches = _no_launches(f"{phase} {tag}")
        res = prob.results
        parts = prob._last_parts
        sizes = prob.layout.sizes
        out = dict(
            path=tag, cycle=cycle, dofs_background=sizes[0],
            dofs_immersed=sizes[1], dofs_multiplier=sizes[2],
            dofs_total=prob.layout.total,
            solve_outer_iterations=solve["outer_iterations"],
            solve_converged=solve["converged"],
            solve_seconds=solve["solve_seconds"],
            build_seconds=solve["build_seconds"],
            solve_host_syncs=solve["host_syncs"],
            refine_steps=res["refine_steps"],
            total_outer_iterations=res["outer_iterations"],
            refined_residual=res["refined_residual"], history=history,
            converged=res["converged"],
            constraint_residual=prob.constraint_residual(),
            setup_seconds=setup_s,
            refine_build_seconds=res["refine_build_seconds"],
            refined_seconds=res["refined_seconds"],
            device_seconds=res["correction_seconds"],
            host_residual_seconds=res["host_residual_seconds"],
            host_syncs=res["host_syncs"],
            gmg_levels=[len(parts["gmg11"].levels),
                        len(parts["gmg22"].levels)],
            gmg_routes=res["gmg_routes"],
            peak_memory_gb=torch.cuda.max_memory_allocated(device) / 1e9,
            launches=launches)
        print(f"{phase}: " + json.dumps(out), flush=True)
        check(solve["converged"], f"{phase} {tag}: solve did not converge")
        check(res["converged"] and history[-1] <= REFINED_TOL,
              f"{phase} {tag}: true residual {history[-1]:.3e} > "
              f"{REFINED_TOL}")
        check(all(x.shape == (n,) and bool(np.isfinite(x).all())
                  for x, n in zip((u, u2, lam), sizes)),
              f"{phase} {tag}: non-finite or misshapen iterate")
        check(math.isfinite(out["constraint_residual"]),
              f"{phase} {tag}: constraint residual not finite")
        rows.append(out)
        del prob, parts
    return rows


def _crosscheck(tag, make, device, rel_tol=1e-3):
    """``make(device)`` solved on the card and on the CPU (float32
    V-cycles on both; the operator and the Krylov solvers float64): outer
    counts within 1, each solution block within ``rel_tol`` of its max |CPU
    value|."""
    import torch

    runs = {}
    for dev in (device, torch.device("cpu")):
        prob, blocks = make(dev)
        res = prob.results
        its = res.get("outer_iterations", res.get("outer_its"))
        runs[dev.type] = ([b.cpu().double() for b in blocks], its,
                          res["converged"])
    (xg, itg, cg_), (xc, itc, cc) = runs["cuda"], runs["cpu"]
    diffs = [float((g - c).abs().max()) for g, c in zip(xg, xc)]
    scales = [float(c.abs().max()) for c in xc]
    out = dict(path=tag, iterations_gpu=itg, iterations_cpu=itc,
               converged=(cg_, cc), max_abs_diff=diffs, max_abs_cpu=scales)
    print("phase 4: " + json.dumps(out), flush=True)
    check(cg_ and cc, f"phase 4 {tag}: a solve did not converge")
    check(abs(itg - itc) <= 1, f"phase 4 {tag}: outer counts {itg} vs {itc}")
    for i, (d, sc) in enumerate(zip(diffs, scales)):
        check(d <= rel_tol * sc, f"phase 4 {tag}: block {i}: |gpu - cpu| = "
              f"{d:.3e} > {rel_tol:g} * {sc:.3e}")
    return out


def phase_family_crosscheck(device):
    """The nitsche problem at cycle 0 and the 3D elasticity problem at
    background refinement 2, immersed 1, on the card against the CPU.  The
    elasticity solve runs to a reduction of 1e-10: at the table's 1e-5 its
    iterate is defined only to a few 1e-3 (the inner CGs stop at an
    absolute 1e-2, where a rounding-level change moves a stop; a float32
    and a float64 V-cycle on the CPU differ by 3e-3 in u and 5e-2 in λ
    there, by 1.3e-7 at 1e-10)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import (
        ElasticityInterfaceProblem, NitscheProblem)

    def nitsche(dev):
        prob = NitscheProblem(nitsche_config(), device=dev,
                              dtype=torch.float32).setup(0)
        prob.solve()
        return prob, (prob.u, prob.lam)

    def elasticity(dev):
        cfg = elasticity_config(small=True)
        cfg.outer.tolerance, cfg.outer.reduction = 1e-14, 1e-10
        prob = ElasticityInterfaceProblem(cfg, device=dev,
                                          dtype=torch.float32)
        prob.setup(0).solve()
        return prob, (prob.u, prob.u2, prob.lam)

    return [_crosscheck("nitsche@0", nitsche, device),
            _crosscheck("elasticity@2:1", elasticity, device)]


def adaptive_config(path, pair=None, flagship_rule=False):
    """A shipped immersed_laplace parameter file read by the port's
    ``from_prm``, its refinement pair overridden by ``pair`` (embedding,
    embedded); ``flagship_rule`` replaces its Schur rule by the
    flagship's float32 one (3e-5 absolute, 1e-6 reduction)."""
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceConfig

    cfg = ImmersedLaplaceConfig.from_prm(path)
    if pair is not None:
        cfg.initial_refinement, cfg.initial_embedded_refinement = pair
    if flagship_rule:
        cfg.schur.tolerance, cfg.schur.reduction = 3e-5, 1e-6
    return cfg


def adaptive_row(path, pair, device, dtype, flagship_rule, warmup,
                 phase="phase 12", degree=1, bf16=False):
    """One row of phase 12: set up (launch counts at 0 just before), an
    optional warm-up solve, a timed solve, counts read just after (all must
    stay 0); returns the row's JSON dict.  ``degree`` is the multiplier's
    (``embedded_space_degree``), ``bf16`` runs the V-cycle in bfloat16
    (phase 14)."""
    import os
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    stem = os.path.splitext(os.path.basename(path))[0]
    prec = "f32" if dtype == torch.float32 else "f64"
    cfg = adaptive_config(path, pair, flagship_rule)
    cfg.embedded_space_degree, cfg.use_bf16_multigrid = degree, bf16
    pair = (cfg.initial_refinement, cfg.initial_embedded_refinement)
    tag = (f"adaptive_{stem}@{pair[0]}:{pair[1]}:{prec}"
           + OPTION_SUFFIX[degree] + ("_bf16" if bf16 else ""))
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    prob = ImmersedLaplaceProblem(cfg, device=device, dtype=dtype).setup()
    setup_s = time.perf_counter() - t0
    warm = {}
    if warmup:
        prob.solve()
        warm = dict(prob.results)
    u, lam, _ = prob.solve()
    res = prob.results
    launches = _no_launches(f"{phase} {tag}") if device.type == "cuda" \
        else {}
    blocks = prob.compact_blocks
    out = dict(
        path=tag, file=path, pair=list(pair), dtype=prec,
        multiplier_degree=degree, gmg_dtype=str(prob._last_gmg.dtype),
        rule="flagship" if flagship_rule else "file",
        dofs_background=prob.space.n_dofs,
        dofs_immersed=prob.imm_space.n_dofs,
        cells=prob.grid.n_cells, max_level=prob.grid.max_level,
        constrained_cells=prob.space.n_constrained_cells,
        gmg_levels=len(prob._last_gmg.levels),
        compact_rows=blocks[0]["rows"], compact_mb=blocks[0]["bytes"] / 1e6,
        compact_seconds=blocks[0]["seconds"],
        setup_seconds=setup_s,
        build_seconds=res["build_seconds"],
        warmup_solve_seconds=warm.get("solve_seconds"),
        warmup_outer_iterations=warm.get("outer_iterations"),
        outer_iterations=res["outer_iterations"],
        converged=res["converged"], residual=res["residual"],
        constraint_residual=prob.constraint_residual(),
        solve_seconds=res["solve_seconds"], host_syncs=res["host_syncs"],
        peak_memory_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        launches=launches)
    if device.type == "cuda":
        print(f"{phase}: " + json.dumps(out), flush=True)
    check(res["converged"], f"{phase} {tag}: solve did not converge "
          f"(residual {res['residual']:.3e})")
    check(math.isfinite(out["constraint_residual"]),
          f"{phase} {tag}: constraint residual not finite")
    check(tuple(u.shape) == (prob.space.n_dofs,)
          and bool(torch.isfinite(u).all())
          and bool(torch.isfinite(lam).all()),
          f"{phase} {tag}: non-finite or misshapen solution")
    del prob
    return out


def phase_adaptive(device):
    """Phase 12: immersed_laplace with one local refinement step near Γ on
    the element-form path, no kernel launched.  Each shipped file of
    :data:`ADAPTIVE_FILES` at :data:`ADAPTIVE_PAIR` ("embedding:embedded"):
    a warm-up and a timed float32 solve under the flagship's rule, then a
    float64 solve at the file's own rule; the flower one refinement above
    that in float32, whose count must be within 2 of its count there; each
    file at its shipped size in float64 at its own rule on the card and on
    the CPU, counts within 1 of each other and of the JAX package's CPU
    count.  Returns the rows."""
    import os
    import torch

    pair = tuple(int(x) for x in ADAPTIVE_PAIR.split(":"))
    scale_pair = (pair[0] + 1, pair[1] + 1)
    rows = []
    f32_counts = {}
    for path in ADAPTIVE_FILES:
        stem = os.path.splitext(os.path.basename(path))[0]
        out = adaptive_row(path, pair, device, torch.float32, True, True)
        f32_counts[stem] = out["outer_iterations"]
        rows.append(out)
        rows.append(adaptive_row(path, pair, device, torch.float64, False,
                                 False))
    stem = os.path.splitext(os.path.basename(ADAPTIVE_SCALE_FILE))[0]
    out = adaptive_row(ADAPTIVE_SCALE_FILE, scale_pair, device,
                       torch.float32, True, True)
    rows.append(out)
    check(abs(out["outer_iterations"] - f32_counts[stem]) <= 2,
          f"phase 12: {stem} takes {out['outer_iterations']} outer "
          f"iterations at {scale_pair} against {f32_counts[stem]} at {pair}")
    for path in ADAPTIVE_FILES:
        stem = os.path.splitext(os.path.basename(path))[0]
        gpu = adaptive_row(path, None, device, torch.float64, False, False)
        cpu = adaptive_row(path, None, torch.device("cpu"), torch.float64,
                           False, False)
        jax_cpu = ADAPTIVE_JAX_CPU_COUNTS[stem]
        gpu.update(cpu_outer_iterations=cpu["outer_iterations"],
                   jax_cpu_outer_iterations=jax_cpu)
        print("phase 12: card against CPU " + json.dumps(gpu), flush=True)
        for other, who in ((cpu["outer_iterations"], "the port's"),
                           (jax_cpu, "the JAX package's")):
            check(abs(gpu["outer_iterations"] - other) <= 1,
                  f"phase 12 {stem}: {gpu['outer_iterations']} outer "
                  f"iterations on the card against {other} on the CPU "
                  f"({who})")
        rows.append(gpu)
    return rows


def phase_adaptive_stokes(device):
    """Phase 13: Stokes with one local refinement step near Γ (every GMG
    level takes the element route, no kernel launched): 2D at
    :data:`ADAPTIVE_STOKES_2D` with ``solve()`` and
    ``solve_refined(tol_abs=1e-8)``, 3D at :data:`ADAPTIVE_STOKES_3D` with
    ``solve_refined``; the true float64 residual must reach 1e-8 and
    the tree must hold fewer background dofs than the uniform grid of its
    finest h.  Returns the rows."""
    rows = []
    for pair, sd in ((ADAPTIVE_STOKES_2D, 2), (ADAPTIVE_STOKES_3D, 3)):
        out = phase_stokes(pair, sd, device, delta_refinement=1)
        ref = int(pair.split(":")[0]) + 1
        uniform = (sd * (2 ** (ref + 1) + 1) ** sd      # Q2 velocity
                   + (2 ** ref + 1) ** sd)               # Q1 pressure
        out["uniform_dofs_same_h"] = uniform
        check(out["dofs_velocity"] + out["dofs_pressure"] < uniform,
              f"phase 13 {out['path']}: {out['dofs_velocity']} + "
              f"{out['dofs_pressure']} background dofs, not fewer than the "
              f"uniform grid's {uniform}")
        check(all(r == "element" for r in out["gmg_routes"]),
              f"phase 13 {out['path']}: a level is not element form: "
              f"{out['gmg_routes']}")
        upair, uouter = UNIFORM_STOKES_OUTER[sd]
        print(f"phase 13: {out['path']}: {out['dofs_velocity']} + "
              f"{out['dofs_pressure']} background dofs against "
              f"{uniform} uniform, GMG routes {out['gmg_routes']}; "
              f"{out['total_outer_iterations']} outer iterations in "
              f"{out['refine_steps']} steps (uniform {upair}: {uouter})",
              flush=True)
        rows.append(out)
    return rows


def phase_options(device, refinement, explicit_ref):
    """Phase 14: the options the port refused before, each through the
    problems' entry points, launch counts set to 0 just before each path
    and read just after.

    - The flagship (data and rule of phase 3) with a DG0 and a Q2
      multiplier at ``refinement``, operator form, W = diag(M): a warm-up
      and a timed solve; K1, K6 and K2 ``op``/``pre``/``post`` must be
      launched, and each is compared with its plain version at the path's
      level shapes with its planes.  The explicit form (W = diag(M)²) at
      ``explicit_ref`` with both degrees: K1 must be launched and agree with
      its plain version at every level shape; the fine compact block's
      rows, MB and seconds are printed.
    - The element-form flower (``ADAPTIVE_SCALE_FILE`` at
      :data:`ADAPTIVE_PAIR` with its one local step) under the flagship's
      rule in float32 with both degrees, and at degree 1 with the float32
      and the bf16 V-cycle, the bf16 count within 2 of the float32 one
      (phase 6's rule).
    - Elliptic (phase 7's configuration) at :data:`OPTIONS_ELLIPTIC_CYCLE`
      with a Q2 background and with a Q2 immersed space, ``solve()`` then
      ``solve_refined(tol_abs=1e-10)``; K6's launches by form are printed.
    - Elasticity with a Q2 background at :data:`OPTIONS_ELASTICITY_CYCLE`,
      ``solve()`` then ``solve_refined(tol_abs=1e-10)``.

    Returns ``(rows, errs)``."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops.kernels import \
        launch_key

    rows, errs = [], []
    for form, ref in (("operator", refinement), ("explicit", explicit_ref)):
        for kdeg in OPTION_DEGREES:
            cfg = (flagship_config(ref) if form == "operator"
                   else al_form_config(ref, "explicit"))
            cfg.embedded_space_degree = kdeg
            tag = (f"{'augmented' if form == 'operator' else 'explicit'}"
                   f"{OPTION_SUFFIX[kdeg]}@{ref}")
            gc.collect()
            torch.cuda.empty_cache()
            prob, out = drive(lambda: ImmersedLaplaceProblem(
                cfg, device=device), device)
            out.update(path=tag, multiplier_degree=kdeg,
                       gmg_levels=len(prob._last_gmg.levels),
                       peak_memory_gb=out["peak_memory_bytes"] / 1e9)
            check(not prob.element_form, f"phase 14 {tag}: not the lattice "
                  "path")
            if form == "operator":
                print("phase 14: " + json.dumps(out), flush=True)
                check(prob.level_stencils[0] is not None,
                      f"phase 14 {tag}: the fine level has no patch planes")
                require_launches(out, ["masked_laplace_2d",
                                       "laplace_stencil_2d"]
                                 + [launch_key(m)
                                    for m in ("op", "pre", "post")],
                                 f"phase 14 {tag}")
                errs += phase_flagship_shapes(prob, device, "phase 14")
            else:
                fine = prob.compact_blocks[0]
                out.update(compact_rows=fine["rows"],
                           compact_mb=fine["bytes"] / 1e6,
                           compact_seconds=fine["seconds"])
                print("phase 14: " + json.dumps(out), flush=True)
                check(fine["seconds"] <= COMPACT_SETUP_LIMIT_S,
                      f"phase 14 {tag}: the fine compact block took "
                      f"{fine['seconds']} s > {COMPACT_SETUP_LIMIT_S} s")
                require_launches(out, ["masked_laplace_2d"],
                                 f"phase 14 {tag}")
                compare_k1_levels(prob, device, tag, errs)
                print(f"phase 14: {tag}: K1 agrees with plain at every "
                      "level shape", flush=True)
            rows.append(out)
            del prob

    pr = tuple(int(x) for x in ADAPTIVE_PAIR.split(":"))
    for kdeg in OPTION_DEGREES:
        rows.append(adaptive_row(ADAPTIVE_SCALE_FILE, pr, device,
                                 torch.float32, True, True, "phase 14",
                                 degree=kdeg))
    f32, b16 = (adaptive_row(ADAPTIVE_SCALE_FILE, pr, device, torch.float32,
                             True, True, "phase 14", bf16=bf16)
                for bf16 in (False, True))
    check(b16["gmg_dtype"] == str(torch.bfloat16),
          "phase 14: the element-form V-cycle is not bf16")
    check(b16["outer_iterations"] <= f32["outer_iterations"] + 2,
          f"phase 14: the bf16 element-form V-cycle takes "
          f"{b16['outer_iterations']} outer iterations against "
          f"{f32['outer_iterations']} in float32")
    rows += [f32, b16]

    for degrees in ((2, 1), (1, 2)):
        out, ell_errs, _ = phase_elliptic(OPTIONS_ELLIPTIC_CYCLE, device,
                                          "phase 14", degrees)
        rows.append(out)
        errs += ell_errs
    rows += phase_elasticity(device, (OPTIONS_ELASTICITY_CYCLE,), "phase 14",
                             degree=2)
    return rows, errs


def options_crosscheck_cases():
    """``[(tag, make)]`` of :func:`phase_options_crosscheck`: ``make(dev)``
    solves one of phase 14's paths at a small size on ``dev`` and returns
    ``(prob, solution blocks)``."""
    import torch
    from fictitious_domain_al_preconditioners_torch.models import (
        ElasticityInterfaceProblem, EllipticInterfaceProblem,
        ImmersedLaplaceProblem)

    def laplace(cfg, dtype=torch.float32):
        def make(dev):
            prob = ImmersedLaplaceProblem(cfg, device=dev,
                                          dtype=dtype).setup()
            prob.solve()
            return prob, (prob.u, prob.lam)

        return make

    def elliptic(degrees):
        def make(dev):
            cfg = elliptic_config()
            cfg.background_space_degree, cfg.immersed_space_degree = degrees
            prob = EllipticInterfaceProblem(cfg, device=dev,
                                            dtype=torch.float32).setup(0)
            prob.solve()
            return prob, (prob.u, prob.u2, prob.lam)

        return make

    def elasticity(dev):
        cfg = elasticity_config(small=True)
        cfg.background_space_degree = 2
        cfg.outer.tolerance, cfg.outer.reduction = 1e-14, 1e-10
        prob = ElasticityInterfaceProblem(cfg, device=dev,
                                          dtype=torch.float32)
        prob.setup(0).solve()
        return prob, (prob.u, prob.u2, prob.lam)

    cases = []
    for kdeg in OPTION_DEGREES:
        cfg = flagship_config(OPTIONS_CROSSCHECK_REFINEMENT)
        cfg.embedded_space_degree = kdeg
        cases.append((f"augmented{OPTION_SUFFIX[kdeg]}@"
                      f"{OPTIONS_CROSSCHECK_REFINEMENT}", laplace(cfg)))
    for kdeg, bf16 in ((0, False), (2, False), (1, True)):
        # the bf16 V-cycle under a float64 outer solve at the file's 1e-10:
        # at the flagship's float32 rule the iterate is defined only to the
        # stop (λ differed by 2e-2 of its max between card and CPU), and
        # the two bf16 cycles round differently
        cfg = adaptive_config(ADAPTIVE_SCALE_FILE, None, not bf16)
        cfg.embedded_space_degree, cfg.use_bf16_multigrid = kdeg, bf16
        cases.append((f"adaptive_flower{OPTION_SUFFIX[kdeg]}"
                      f"{'_bf16' if bf16 else ''}",
                      laplace(cfg, torch.float64 if bf16 else torch.float32)))
    cases += [("elliptic@0_q2_background", elliptic((2, 1))),
              ("elliptic@0_q2_immersed", elliptic((1, 2))),
              ("elasticity@2:1_q2_background", elasticity)]
    return cases


def phase_options_crosscheck(device):
    """Phase 14's paths on the card against the CPU at a small size (float32
    V-cycles on both; elliptic and elasticity keep their float64 operators
    and Krylov solvers): the flagship with a DG0 and a Q2 multiplier at
    :data:`OPTIONS_CROSSCHECK_REFINEMENT`, the element-form flower at its
    shipped size with both degrees and with the bf16 V-cycle (float64
    outer solve at the file's rule), elliptic with
    a Q2 background and a Q2 immersed space at cycle 0, elasticity with a
    Q2 background at background refinement 2, immersed 1 (to a reduction of
    1e-10, as phase 4 holds it): counts within 1, blocks within 1e-3 of
    each block's max."""
    return [_crosscheck(tag, make, device)
            for tag, make in options_crosscheck_cases()]


def _forms(fn, *args):
    """``fn(*args)`` with the C++ routines and with their NumPy forms:
    ``((native result, seconds), (numpy result, seconds))``."""
    import contextlib
    from unittest import mock

    from fictitious_domain_al_preconditioners_torch import native

    out = []
    for numpy_form in (False, True):
        with (mock.patch.object(native, "available", lambda: False)
              if numpy_form else contextlib.nullcontext()):
            t0 = time.perf_counter()
            res = fn(*args)
            out.append((res, time.perf_counter() - t0))
    return out


def _close(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape, f"phase 15 {what}: shapes {a.shape} vs "
          f"{b.shape}")
    err = float(np.abs(a - b).max()) if a.size else 0.0
    scale = max(float(np.abs(b).max()), 1e-300) if b.size else 1.0
    check(err <= tol * scale, f"phase 15 {what}: |native - numpy| = {err:.3e}"
          f" > {tol} x {scale:.3e}")
    return err / scale


def phase_native(device):
    """Phase 15, first part: the C++ setup routines are in use and equal
    their NumPy forms at elliptic cycle 6's coupling quadrature points and
    on the flower's (11, 12) + 1 compact AL block; returns the line."""
    from fictitious_domain_al_preconditioners_torch import native
    from fictitious_domain_al_preconditioners_torch.core import (
        GridSpace, ImmersedSpace, gauss)
    from fictitious_domain_al_preconditioners_torch.core.generators import (
        background_grid_from_name, immersed_mesh_from_name)
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops.coupling import \
        build_coupling

    check(native.available(), "phase 15: the C++ setup library is not in "
          "use (no C++ compiler?)")
    out = dict(path="native", library=os.path.relpath(native.build(), ROOT))
    cfg, cyc = elliptic_config(), NATIVE_ELLIPTIC_CYCLE
    grid = background_grid_from_name(
        cfg.name_of_background_grid, cfg.arguments_for_background_grid, 2,
        cfg.initial_background_refinement + cyc)
    box = background_grid_from_name(
        cfg.name_of_immersed_grid, cfg.arguments_for_immersed_grid, 2,
        cfg.initial_immersed_refinement + cyc)
    mesh = immersed_mesh_from_name(
        cfg.name_of_immersed_grid, cfg.arguments_for_immersed_grid, 2,
        cfg.initial_immersed_refinement + cyc)
    X, _, _ = mesh.quad_geometry(gauss(2, cfg.background_space_degree + 1))
    pts = X.reshape(-1, 2)
    space = GridSpace.q(grid, 1)
    (loc, t_loc), (loc_np, t_loc_np) = _forms(
        native.locate_points, pts, np.asarray(grid.origin), grid.h,
        np.asarray(grid.ncells))
    check(np.array_equal(loc[0], loc_np[0]), "phase 15: located cells "
          "differ")
    _close(loc[1], loc_np[1], 1e-14, "reference points")
    (tab, t_tab), (tab_np, t_tab_np) = _forms(
        native.tabulate, loc[1], space.fe.nodes_1d, 2)
    _close(tab, tab_np, 1e-14, "tabulation")
    twin = GridSpace.q(box, 1)
    C = build_coupling(space, ImmersedSpace(mesh, twin.fe, twin.cell_dofs,
                                            twin.n_dofs),
                       cfg.background_space_degree + 1, device="cpu")
    rows, cols, vals = C.to_coo()
    ((r, c, v), t_dd), ((r_np, c_np, v_np), t_dd_np) = _forms(
        native.coo_dedup, rows, cols, vals, C.shape[1])
    check(np.array_equal(r, r_np) and np.array_equal(c, c_np),
          "phase 15: deduplicated COO indices differ")
    _close(v, v_np, 1e-13, "deduplicated COO values")
    out.update(elliptic_cycle=cyc, quadrature_points=len(pts),
               coo_triplets=len(vals), coo_unique=len(v),
               locate_seconds=t_loc, locate_numpy_seconds=t_loc_np,
               tabulate_seconds=t_tab, tabulate_numpy_seconds=t_tab_np,
               coo_dedup_seconds=t_dd, coo_dedup_numpy_seconds=t_dd_np)
    del C, rows, cols, vals

    acfg = adaptive_config(os.path.join(ROOT, ADAPTIVE_SCALE_FILE),
                           NATIVE_FLOWER_PAIR, True)
    t0 = time.perf_counter()
    prob = ImmersedLaplaceProblem(acfg, device=device).setup()
    setup_s = time.perf_counter() - t0
    h = prob.C.host
    uniq, inv = np.unique(h["bg_dofs"].reshape(-1), return_inverse=True)
    idx = inv.reshape(h["bg_dofs"].shape)
    (A, t_acc), (A_np, t_acc_np) = _forms(
        native.accumulate_al, idx, h["bg_phi"], h["jxw"], len(uniq))
    err = _close(A, A_np, 1e-12, "compact AL block")
    out.update(flower_pair=list(NATIVE_FLOWER_PAIR),
               flower_setup_seconds=setup_s, block_rows=len(uniq),
               block_quadrature_points=idx.shape[0],
               accumulate_seconds=t_acc, accumulate_numpy_seconds=t_acc_np,
               accumulate_rel_err=err)
    del prob, A, A_np
    print("phase 15: " + json.dumps(out), flush=True)
    return out


def _script_cmd(script, *args):
    """A command that runs ``scripts/<script>`` with ``jax`` blocked and
    fails if it loaded jax or the JAX package."""
    path = os.path.join(ROOT, "scripts", script)
    code = ("import runpy, sys\nsys.modules['jax'] = None\n"
            f"sys.argv = {[path, *args]!r}\n"
            f"try:\n    runpy.run_path({path!r}, run_name='__main__')\n"
            "finally:\n    assert sys.modules['jax'] is None\n"
            "    assert 'fictitious_domain_al_preconditioners_tpu' not in "
            "sys.modules\n")
    return [sys.executable, "-c", code]


def phase_table(device):
    """Phase 15, second part: ``scripts/measure_family_torch.py`` on the
    smallest row of each family (one process a family, all at once, jax
    blocked) into a temporary cache, the table rendered from it, every row
    converged with finite numbers; the kernels each row must launch.
    Returns the rows' entries by key."""
    with tempfile.TemporaryDirectory() as tmp:
        cache, table = (os.path.join(tmp, f) for f in ("rows.json",
                                                        "results.md"))
        t0 = time.perf_counter()
        procs = {kind: subprocess.Popen(
            _script_cmd("measure_family_torch.py", kind, arg, "--cache",
                        cache, "--device", device.type), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for kind, arg in TABLE_SMOKE_ROWS.items()}
        logs = {}
        try:
            for kind, proc in procs.items():
                logs[kind], _ = proc.communicate(timeout=900)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for kind, proc in procs.items():
            check(proc.returncode == 0, f"phase 15: measure_family_torch.py "
                  f"{kind} exited {proc.returncode}:\n{logs[kind][-2000:]}")
        res = subprocess.run(_script_cmd(
            "make_results_table_torch.py", "--render", "--cache", cache,
            "--out", table), cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        check(res.returncode == 0, "phase 15: rendering failed:\n"
              + res.stdout[-1000:] + res.stderr[-2000:])
        with open(cache) as fh:
            entries = json.load(fh)
        with open(table) as fh:
            text = fh.read()
    seconds = time.perf_counter() - t0
    for kind, arg in TABLE_SMOKE_ROWS.items():
        key = f"{kind}:{arg}"
        ent = entries.get(key)
        check(ent is not None and ent.get("row") is not None,
              f"phase 15: no row for {key}: {ent}")
        row = ent["row"]
        print("phase 15: table row " + json.dumps(dict(
            key=key, row=row, setup_seconds=ent.get("setup_seconds"),
            build_seconds=ent.get("build_seconds"), peak_gb=ent["peak_gb"],
            launches=ent["launches"], card=ent["card"])), flush=True)
        check(all(math.isfinite(x) for x in row
                  if isinstance(x, (int, float))),
              f"phase 15: {key}: a number is not finite: {row}")
        if len(row) >= 7:           # refined rows end in their flag
            check(bool(row[6]), f"phase 15: {key} did not converge: {row}")
        check(f"| {row[0]:,} | {row[1]:,} | {row[2]} |" in text,
              f"phase 15: {key} is not in the rendered table")
        for name in TABLE_SMOKE_LAUNCHES.get(key, ()):
            check(ent["launches"].get(name, 0) > 0,
                  f"phase 15: {key}: {name} never launched")
    for mark in ("**diverged**", "**(unconverged)**", "**cut**", "failed:",
                 " †"):
        check(mark not in text, f"phase 15: the table holds '{mark}'")
    print(f"phase 15: the smallest row of {len(TABLE_SMOKE_ROWS)} families "
          f"measured and rendered in {seconds:.1f} s", flush=True)
    return {f"{k}:{a}": entries[f"{k}:{a}"]
            for k, a in TABLE_SMOKE_ROWS.items()}


def phase_host_and_table(device, path_launches):
    """Phase 15: :func:`phase_native`, then :func:`phase_table`, whose rows'
    launches join ``path_launches`` as ``table_<key>``."""
    t0 = time.perf_counter()
    phase_native(device)
    for key, ent in phase_table(device).items():
        path_launches[f"table_{key}"] = ent["launches"]
    print(f"phase 15: passed in {time.perf_counter() - t0:.1f} s",
          flush=True)


def sharded_kernel_checks(prob, run, out):
    """On a rank of phase 16, after its solve: every kernel of its path
    against its plain version at this rank's shapes: K1 and K6 at the
    fine extended block of the Dirichlet lift; on each distributed level
    (and the outer operator's own fine level, under a bf16 V-cycle or
    with W = M²) K2 in all four modes with the level's block stencils (the
    halo of ``op`` and of the sweeps, the patch box clipped to the block,
    no patch where none of it is left) and its Lanczos bound, or K1 in the
    level's dtype (float32, bf16) at its extended block; and the replicated
    tail's levels (K2 and K1 on whole coarse lattices).  The element form
    runs no kernel and checks none.  Adds ``errs`` (the comparisons),
    ``kernel_checks`` and ``block_shapes`` to ``out``."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K
    from fictitious_domain_al_preconditioners_torch.parallel.mesh import (
        HALO, ext_rows)

    dev, errs, shapes = prob.device, [], []
    rank = run.mesh.rank
    if run.flat:
        out.update(errs=errs, kernel_checks=0, block_shapes=shapes)
        return
    fine = run.blocks[0]
    a, b = ext_rows(run.mesh, fine, HALO["laplace"])
    tag = f"rank {rank} fine block rows {a}:{b}"
    h = tuple(1.0 / (n - 1) for n in (fine.ny, fine.nx))
    compare_stencils(h, (b - a, fine.nx), dev, seed=1600, tag=tag, errs=errs)
    levels = list(enumerate(prob.sharded_levels))
    if prob.sharded_outer is not None:
        levels.append(("outer", prob.sharded_outer))
    for i, lv in levels:
        if lv["kind"] == "k2":
            lam = lv.get("lam_max", run.gmg.levels[0].lam_max)
            for depth, st in lv["stencils"].items():
                shapes.append(dict(level=i, kind="k2", halo=depth,
                                   shape=list(st.shape), box=list(st.box)))
                compare_fused(st, dev, lam, seed=1610 + len(shapes),
                              tag=f"rank {rank} level {i} halo {depth} "
                              f"{st.shape} box {st.box}", errs=errs)
            continue
        a, b = lv["ext"]
        shape = (b - a, fine.nx)
        shapes.append(dict(level=i, kind="k1", dtype=lv["dtype"],
                           halo=HALO["op"], shape=list(shape)))
        tag = f"rank {rank} level {i} K1 {lv['dtype']} {shape}"
        u = torch.as_tensor(np.random.default_rng(1620 + len(shapes))
                            .standard_normal(shape), dtype=torch.float32,
                            device=dev)
        if lv["dtype"] == "bfloat16":
            compare_k1_bf16(lv["h"], u, tag, errs)
        else:
            record(errs, "masked_laplace_2d", "-", tag,
                   K.masked_laplace_2d(u, lv["h"]),
                   K.masked_laplace_2d_plain(u, lv["h"]))
    first = len(prob.sharded_levels) - run.gmg.direct
    for j, (level, st) in enumerate(zip(run.gmg.tail.levels,
                                        prob.level_stencils)):
        lat = tuple(reversed(level.space.n_points_1d))
        tag = f"rank {rank} tail level {first + j} {lat}"
        compare_stencils(tuple(1.0 / (n - 1) for n in lat), lat, dev,
                         seed=1630 + j, tag=tag, errs=errs)
        if st is not None:
            compare_fused(st, dev, level.lam_max, seed=1640 + j, tag=tag,
                          errs=errs)
    out.update(errs=errs, kernel_checks=len(errs), block_shapes=shapes)


def _sharded_line(res, ranks, backend, wall, serial, cmp, smi,
                  path=None):
    """Phase 16's JSON line of one sharded run (``res``: every rank's
    result; ``cmp``: ``compare_to_serial``'s)."""
    r0 = res[0]
    keys = ("rows", "setup_seconds", "build_seconds", "solve_seconds",
            "host_syncs", "counts", "peak_gb", "launches", "kernel_checks",
            "distributed_levels", "levels", "level_kinds", "compact_levels")
    return dict(
        path=path or f"sharded_ws{ranks}", world_size=ranks, backend=backend,
        transport=r0["transport"], refinement=r0["refinement"],
        dofs_background=r0["dofs_background"],
        dofs_immersed=r0["dofs_immersed"], dtype=r0["dtype"],
        outer_iterations=r0["iterations"],
        serial_outer_iterations=serial["outer_iterations"],
        converged=r0["converged"], residual=r0["residual"],
        drifts=cmp["drifts"], limits=cmp["limits"],
        serial_spread=serial.get("spread"),
        serial_seconds={k: serial[k] for k in (
            "setup_seconds", "build_seconds", "solve_seconds")},
        halo_bytes_a_solve=sum(r["counts"]["halo_bytes"] for r in res),
        wall_seconds=wall, card=smi,
        ranks=[{k: r[k] for k in keys} for r in res])


def sharded_form_config(name, refinement):
    """The configuration of one of phase 16's :data:`SHARDED_FORMS` at the
    flagship's ``refinement`` (the explicit forms and the band at most
    :data:`EXPLICIT_REFINEMENT`)."""
    explicit_ref = min(EXPLICIT_REFINEMENT, refinement)
    if name == "bf16":
        return flagship_config(refinement, bf16=True)
    if name == "exactw":
        return al_form_config(refinement, name)
    if name.startswith("explicit"):
        return al_form_config(explicit_ref, name)
    if name == "band":
        cfg = flagship_config(explicit_ref)
        cfg.embedded_configuration = SHARDED_BAND_CIRCLE
        return cfg
    pair = tuple(int(x) for x in ADAPTIVE_PAIR.split(":"))
    return adaptive_config(os.path.join(ROOT, ADAPTIVE_SCALE_FILE), pair,
                           flagship_rule=True)


def sharded_form_launches(name, r):
    """The kernels a rank of phase 16's configuration ``name`` must have
    launched: K6 (the Dirichlet lift) and the fine level's kernels: K2
    ``op``/``pre``/``post`` in operator form with an interior band (and K1
    where a tail level is compact), K2 ``op`` (the outer operator) and
    K2's bf16 form (and K1's where a tail level is compact) under the bf16
    V-cycle, K1 in the explicit forms and on
    a band on ∂Ω; none on the element form (the flower)."""
    from fictitious_domain_al_preconditioners_torch.ops.kernels import \
        launch_key

    if name == "flower":
        return []
    keys = ["laplace_stencil_2d"]
    if name == "bf16":
        keys += [launch_key("op")] + [launch_key(m, bf16=True)
                                      for m in ("op", "pre", "post")]
        return keys + (["masked_laplace_2d:bf16"] if r["compact_levels"]
                       else [])
    if name in ("flagship", "exactw"):
        keys += [launch_key(m) for m in ("op", "pre", "post")]
        if not r["compact_levels"]:
            return keys
    return keys + ["masked_laplace_2d"]


def phase_sharded(refinement, device, smi):
    """Phase 16: the row-block sharded flagship (``build_sharded_solver``
    through ``parallel.dryrun.sharded_flagship_rank``) at the refinement,
    on one rank over NCCL and on ``SHARDED_RANKS`` ranks sharing the card
    (gloo, host-staged halos), each held to the serial solve
    (``parallel.dryrun.serial_reference``; both with deterministic
    algorithms) by ``parallel.dryrun.compare_to_serial``: outer count, u
    and the seeded probe through the fine operator and the V-cycle.  Every
    rank's launch counts (set to 0 before its setup, read after its solve)
    must show K6, K2 ``op``/``pre``/``post`` and K1 where its tail has a
    compact level, and every kernel is compared with its plain version at
    the rank's shapes (:func:`sharded_kernel_checks`); then NCCL with one
    rank a card when two or more are visible; then the other
    configurations (:func:`phase_sharded_forms`); then
    ``dryrun_multichip(2)``.  Returns ``(errs, path_launches)``."""
    import torch
    from fictitious_domain_al_preconditioners_torch.parallel.dryrun import (
        compare_to_serial, dryrun_multichip, serial_reference,
        sharded_flagship_rank)
    from fictitious_domain_al_preconditioners_torch.parallel.mesh import \
        launch

    t_phase = time.perf_counter()
    cfg = flagship_config(refinement)
    serial = serial_reference(cfg, device, spread=True)
    print("phase 16: serial " + json.dumps(
        {k: v for k, v in serial.items() if k not in ("u", "lam", "probe")}),
        flush=True)
    check(serial["converged"], "phase 16: the serial solve did not converge")
    torch.cuda.empty_cache()
    errs, path_launches = [], {}
    cards = torch.cuda.device_count()
    runs = [(1, "nccl", f"cuda:{device.index}"),
            (SHARDED_RANKS, "gloo", f"cuda:{device.index}")]
    if cards >= 2:
        runs.append((cards, "nccl", "cuda"))
    for ranks, backend, where in runs:
        t0 = time.perf_counter()
        res = launch(sharded_flagship_rank, ranks, backend=backend,
                     device=where, args=(cfg, None, False,
                                         sharded_kernel_checks),
                     timeout=SHARDED_TIMEOUT_S)
        cmp = compare_to_serial(res, serial)
        line = _sharded_line(res, ranks, backend, time.perf_counter() - t0,
                             serial, cmp, smi)
        print("phase 16: " + json.dumps(line), flush=True)
        tag = f"phase 16 {line['path']} ({backend}, {line['transport']})"
        check(not cmp["failures"], f"{tag}: " + "; ".join(cmp["failures"]))
        for r in res:
            require_launches(r, sharded_form_launches("flagship", r),
                             f"{tag} rank {r['rank']}")
            errs += r["errs"]
            path_launches[f"{line['path']}_{backend}_rank{r['rank']}"] = \
                r["launches"]
    if cards < 2:
        print(f"phase 16: NCCL with one rank a card skipped: {cards} card "
              "visible", flush=True)
    forms_errs, forms_launches = phase_sharded_forms(refinement, device, smi)
    errs += forms_errs
    path_launches.update(forms_launches)
    t0 = time.perf_counter()
    dry = dryrun_multichip(2)
    print("phase 16: dryrun_multichip(2) " + json.dumps(dict(
        seconds=time.perf_counter() - t0, ranks=dry)), flush=True)
    print(f"phase 16: passed in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return errs, path_launches


def phase_sharded_forms(refinement, device, smi):
    """Phase 16's other configurations (:data:`SHARDED_FORMS`, sizes in
    :func:`sharded_form_config`): all of them on ``SHARDED_RANKS`` ranks
    sharing the card in one start of the ranks
    (``parallel.dryrun.sharded_runs_rank``; each run's launch counts set to
    0 before its setup and read after its solve) and, while the ranks run,
    a deterministic serial solve of each in this process (their limits are
    read, so no second serial solve measures the spread; the seconds of
    both sides share the card and the host); each run held to its serial
    solve by ``compare_to_serial`` within its ``SERIAL_LIMITS``; every rank
    must have launched the kernels of :func:`sharded_form_launches` (none
    on the element form) and every kernel agrees with its plain version at
    the rank's shapes (:func:`sharded_kernel_checks`).  Returns ``(errs,
    path_launches)``."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from fictitious_domain_al_preconditioners_torch.parallel.dryrun import (
        compare_to_serial, serial_reference, sharded_runs_rank)
    from fictitious_domain_al_preconditioners_torch.parallel.mesh import \
        launch

    cfgs = {name: sharded_form_config(name, refinement)
            for name in SHARDED_FORMS}
    serials, failures = {}, []
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            launch, sharded_runs_rank, SHARDED_RANKS, backend="gloo",
            device=str(device),
            args=([(cfg, None) for cfg in cfgs.values()],
                  sharded_kernel_checks),
            timeout=SHARDED_FORMS_TIMEOUT_S)
        for name, cfg in cfgs.items():
            serials[name] = serial_reference(cfg, device)
            print(f"phase 16: serial {name} " + json.dumps(
                {k: v for k, v in serials[name].items()
                 if k not in ("u", "lam", "probe")}), flush=True)
            if not serials[name]["converged"]:
                failures.append(f"phase 16: the serial {name} solve did "
                                "not converge")
            gc.collect()
            torch.cuda.empty_cache()
        res_all = ranks.result()
    wall = time.perf_counter() - t0
    print(f"phase 16: {len(cfgs)} configurations on {SHARDED_RANKS} ranks, "
          f"their serial solves beside them, in {wall:.1f} s", flush=True)
    check(not failures, "; ".join(failures))
    errs, path_launches = [], {}
    for k, name in enumerate(cfgs):
        res = [r[k] for r in res_all]
        cmp = compare_to_serial(res, serials[name], name)
        path = f"sharded_{name}_ws{SHARDED_RANKS}"
        line = _sharded_line(res, SHARDED_RANKS, "gloo", None, serials[name],
                             cmp, smi, path=path)
        line["configuration"] = name
        print("phase 16: " + json.dumps(line), flush=True)
        tag = f"phase 16 {path} (gloo, {line['transport']})"
        failures += [f"{tag}: {f}" for f in cmp["failures"]]
        for r in res:
            keys = sharded_form_launches(name, r)
            require_launches(r, keys, f"{tag} rank {r['rank']}")
            if not keys:
                check(not r["launches"], f"{tag} rank {r['rank']}: kernels "
                      f"launched on the element form: {r['launches']}")
            errs += r["errs"]
            path_launches[f"{path}_gloo_rank{r['rank']}"] = r["launches"]
    check(not failures, "; ".join(failures))
    return errs, path_launches


def k1_resources(shape):
    """Resources of K1's two forms, keyed as in the kernels line: of the
    instantiation a launch on ``shape`` takes, with every instantiation's
    under ``chunks``."""
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    res = {}
    for name, bf16 in (("masked_laplace_2d", False),
                       ("masked_laplace_2d:bf16", True)):
        tile = K.masked_laplace_tile(*shape, bf16=bf16)
        res[name] = dict(
            K.masked_laplace_resources(bf16, tile["chunk_rows"]), **tile,
            chunks={c: K.masked_laplace_resources(bf16, c)
                    for c in K.K1_CHUNKS})
    return res


def k6_resources(shape):
    """Resources of K6's two forms, keyed as in the kernels line: of the
    instantiation a launch on ``shape`` takes (both forms take the same
    plan), with every instantiation's under ``chunks``."""
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    tile = K.laplace_stencil_tile(*shape)
    return {name: dict(
        K.laplace_stencil_resources(tile["chunk_rows"], f64), **tile,
        chunks={c: K.laplace_stencil_resources(c, f64) for c in K.K1_CHUNKS})
        for name, f64 in (("laplace_stencil_2d", False),
                          ("laplace_stencil_2d:f64", True))}


def k2_resources(shape, degree=4):
    """Resources of the K2 instantiations on the main paths (``op``, and
    ``pre``/``post`` at ``degree``, each with and without patch, and each
    mode in bf16 storage), keyed as the modes of the kernels line; the
    patched ``op``'s are of the instantiation a launch on ``shape`` takes,
    with its plan and every instantiation's under ``chunks``."""
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    res = {}
    for patch in (True, False):
        for mode in K.MODES:
            key = mode if patch else f"{mode}:no_patch"
            res[key] = K.fused_augmented_resources(mode, degree, patch)
    for mode in K.MODES:
        res[f"{mode}:bf16"] = K.fused_augmented_resources(mode, degree,
                                                          bf16=True)
    tile = K.augmented_op_tile(*shape)
    res["op"] = dict(
        K.fused_augmented_resources("op", degree, True, tile["chunk_rows"]),
        **tile, chunks={c: K.fused_augmented_resources("op", degree, True, c)
                        for c in K.K1_CHUNKS})
    return res


def kernel_report(path_launches, errs, times, resources):
    """The kernels' JSON line: one entry per kernel (K1's bf16 form and K6's
    float64 form their own), K2's modes inside.  ``launches`` sums the
    paths of phases 3, 5 (with its rational table rows), 6-14, the table
    rows of phase 15 (``table_<key>``) and the ranks of phase 16
    (``sharded_ws<n>_<backend>_rank<r>``; ``launches_by_path`` lists them;
    0 on the Stokes, nitsche, elasticity and locally refined paths)."""
    from fictitious_domain_al_preconditioners_torch.ops.kernels import (
        MODES, launch_key)

    def worst(kernel, mode=None):
        return max(e[3] for e in errs if e[0] == kernel
                   and (mode is None or e[1] == mode))

    def launches(key):
        by_path = {p: n.get(key, 0) for p, n in path_launches.items()}
        return sum(by_path.values()), by_path

    def entry(name, t):
        total, by_path = launches(name)
        return dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], launches=total,
                    launches_by_path=by_path, max_abs_err=worst(name),
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], shape=t["shape"],
                    **{k: t[k] for k in (
                        "copy_ms", "k2_op_ms", "graph_ms", "copy_graph_ms",
                        "k2_op_graph_ms", "k1_graph_ms", "levels")
                       if k in t},
                    **resources.get(name, {}))

    modes = {}
    for patch in (True, False):
        for m in MODES:
            key = m if patch else f"{m}:no_patch"
            total, by_path = launches(launch_key(m, patch))
            modes[key] = dict(times[key], **resources[key],
                              source=MODE_SOURCE.get(key, MODE_SOURCE[m]),
                              launches=total,
                              launches_by_path=by_path,
                              max_abs_err=worst("fused_augmented_2d", key))
    for m in MODES:
        # bf16 storage: the form without planes runs the same instantiation
        key = f"{m}:bf16"
        by_path = {p: n.get(launch_key(m, True, True), 0)
                   + n.get(launch_key(m, False, True), 0)
                   for p, n in path_launches.items()}
        modes[key] = dict(times[key], **resources[key],
                          source=MODE_SOURCE["bf16"],
                          launches=sum(by_path.values()),
                          launches_by_path=by_path,
                          max_abs_err=worst("fused_augmented_2d", key))
    # K2's own times are those of its patched op mode; its launches sum
    # every mode, form and dtype
    k2 = entry("fused_augmented_2d", times["op"])
    k2.update(resources["op"])
    k2["launches_by_path"] = {
        p: sum(n.get(launch_key(m, q, h), 0) for m in MODES
               for q in (True, False) for h in (False, True))
        for p, n in path_launches.items()}
    k2["launches"] = sum(k2["launches_by_path"].values())
    k2["modes"] = modes
    return {"kernels": [
        entry("masked_laplace_2d", times["masked_laplace_2d"]),
        entry("masked_laplace_2d:bf16", times["masked_laplace_2d:bf16"]),
        k2,
        entry("laplace_stencil_2d", times["laplace_stencil_2d"]),
        entry("laplace_stencil_2d:f64", times["laplace_stencil_2d:f64"]),
    ]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refinement", type=int, default=12,
                    help="refinement of the flagship (float32 and bf16 "
                         "V-cycle), rational and CG solves (ELMAN_triang "
                         f"runs at min({ELMAN_REFINEMENT}, this), "
                         f"solve_refined at min({REFINED_REFINEMENT}, "
                         "this))")
    ap.add_argument("--elliptic-cycle", type=int, default=ELLIPTIC_CYCLE,
                    help="cycle of the elliptic interface phase (background "
                         "refinement 5 + cycle, immersed 3 + cycle)")
    ap.add_argument("--elliptic-only", action="store_true",
                    help="build the kernels and run only the elliptic "
                         "phase and its cross-check (no kernels line)")
    ap.add_argument("--stokes-refinement", default=STOKES_2D,
                    help="background:immersed refinements of the 2D Stokes "
                         "row of phase 8")
    ap.add_argument("--stokes3d-refinement", default=STOKES_3D,
                    help="background:immersed refinements of the 3D Stokes "
                         "row of phase 8")
    ap.add_argument("--stokes-only", action="store_true",
                    help="run only the Stokes phase and its cross-check (no "
                         "kernels line)")
    ap.add_argument("--elasticity-cycle", type=int, default=ELASTICITY_CYCLE,
                    help="last cycle of phase 11 (background refinement 3 + "
                         "cycle, immersed 2 + cycle; 3 is the scale row of "
                         "1,039,497 dofs, cut from the default run)")
    ap.add_argument("--families-only", action="store_true",
                    help="run only phases 9-11, the rational table rows and "
                         "their cross-checks (no kernels line)")
    ap.add_argument("--elasticity-only", action="store_true",
                    help="run only phase 11 (no kernels line)")
    ap.add_argument("--adaptive-only", action="store_true",
                    help="run only phases 12 and 13, local refinement near "
                         "Γ (no kernels line)")
    ap.add_argument("--table-only", action="store_true",
                    help="run only phase 15 (the C++ host setup routines "
                         "and the results table's scripts on the smallest "
                         "row of each family; no kernels line)")
    ap.add_argument("--options-only", action="store_true",
                    help="run only phase 14 (multiplier degrees 0 and 2, "
                         "the bf16 element-form V-cycle, Q2 elliptic and "
                         "elasticity) and its cross-checks (no kernels "
                         "line)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run only phases 1 and 2 and time K2 in float32 "
                         "and in bf16 storage at the refinement's fine "
                         "lattice with the flagship's planes (no kernels "
                         "line)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="run only phase 16, the sharded solves (the "
                         "flagship on one rank over NCCL and two ranks on "
                         "the card, the other configurations on two, "
                         "dryrun_multichip(2)), each held to a serial solve "
                         "(no kernels line)")
    args = ap.parse_args(argv)
    explicit_ref = min(EXPLICIT_REFINEMENT, args.refinement)
    nitsche_cycles = tuple(sorted(set(NITSCHE_CYCLES) | {
        min(NITSCHE_SCALE_CYCLE, args.refinement - 4)}))
    elasticity_cycles = tuple(range(args.elasticity_cycle + 1))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from fictitious_domain_al_preconditioners_torch.ops import kernels as K
    except ImportError as exc:
        print(f"chip_smoke: cannot import {PKG}: {exc}", file=sys.stderr)
        return 1
    try:
        t_start = time.perf_counter()
        device = torch.device("cuda", 0)
        torch.cuda.init()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(f"phase 1: card {smi}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        t0 = time.perf_counter()
        K._library()
        print(f"phase 1: kernels built and loaded in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        n = 2 ** args.refinement + 1
        resources = k1_resources((n, n))
        for key, r in resources.items():
            print(f"phase 1: K1 {key} at {n}²: {json.dumps(r)}", flush=True)
            for chunk, rc in r["chunks"].items():
                check(rc["local_bytes"] == 0, f"K1 {key} chunk {chunk} "
                      f"spills {rc['local_bytes']} bytes a thread")
        k2 = k2_resources((n, n))
        resources.update(k2)
        resources.update(k6_resources((n, n)))
        for key, r in k2.items():
            print(f"phase 1: K2 {key} (degree 4): {json.dumps(r)}",
                  flush=True)
            check(r["local_bytes"] == 0, f"K2 {key} spills "
                  f"{r['local_bytes']} bytes a thread")
        for key in ("laplace_stencil_2d", "laplace_stencil_2d:f64"):
            print(f"phase 1: K6 {key} at {n}²: {json.dumps(resources[key])}",
                  flush=True)
        for name, r in (("K6", resources["laplace_stencil_2d"]),
                        ("K6 f64", resources["laplace_stencil_2d:f64"]),
                        ("K2 op", k2["op"])):
            for chunk, rc in r["chunks"].items():
                check(rc["local_bytes"] == 0, f"{name} chunk {chunk} spills "
                      f"{rc['local_bytes']} bytes a thread")

        if args.kernels_only:
            phase_kernels(device)
            print_times(time_k2_rows(args.refinement, device))
            print(f"chip_smoke: phases 1 and 2 passed in "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            return 0
        if args.sharded_only:
            phase_sharded(args.refinement, device, smi)
            print(f"chip_smoke: phase 16 passed in "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            return 0
        if args.stokes_only:
            for pair, sd in ((args.stokes_refinement, 2),
                             (args.stokes3d_refinement, 3)):
                phase_stokes(pair, sd, device)
            phase_stokes_crosscheck(device)
            print(f"chip_smoke: the Stokes phases passed in "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            return 0
        if args.adaptive_only:
            phase_adaptive(device)
            phase_adaptive_stokes(device)
            print(f"chip_smoke: phases 12 and 13 passed in "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            return 0
        if args.table_only:
            phase_host_and_table(device, {})
            print(f"chip_smoke: phase 15 passed in "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            return 0
        if args.options_only:
            phase_options(device, args.refinement, explicit_ref)
            phase_options_crosscheck(device)
            print(f"chip_smoke: phase 14 passed in "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            return 0
        if args.elasticity_only:
            phase_elasticity(device, elasticity_cycles)
            print(f"chip_smoke: phase 11 passed in "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            return 0
        if args.families_only:
            phase_al_forms(args.refinement, explicit_ref, device)
            phase_rational_table(device)
            phase_nitsche(device, nitsche_cycles)
            phase_elasticity(device, elasticity_cycles)
            phase_family_crosscheck(device)
            print(f"chip_smoke: phases 9-11 passed in "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            return 0
        if args.elliptic_only:
            _, _, ell_space = phase_elliptic(args.elliptic_cycle, device)
            time_k6_f64(ell_space, device, {})
            phase_elliptic_crosscheck(device)
            print(f"chip_smoke: the elliptic phases passed in "
                  f"{time.perf_counter() - t_start:.1f} s", flush=True)
            return 0
        errs = phase_kernels(device)
        path_launches, times = {}, {}
        prob, flag = phase_flagship(args.refinement, device)
        path_launches["augmented"] = flag["launches"]
        errs += phase_flagship_shapes(prob, device)
        fine = prob.level_stencils[0]
        time_stencils(fine.h, fine.shape, device, times)
        level_shapes = [tuple(reversed(level.space.n_points_1d))
                        for level in prob._last_gmg.levels]
        time_fused(fine, prob._last_gmg.levels[0].lam_max,
                   prob.cfg.gmg_smoother_degree, device, times)
        time_window_levels(level_shapes, prob.level_stencils, device, times)
        del prob
        torch.cuda.empty_cache()
        sharded_errs, sharded_launches = phase_sharded(args.refinement,
                                                       device, smi)
        errs += sharded_errs
        path_launches.update(sharded_launches)

        for solver in MODE_SOLVERS:
            ref = (min(ELMAN_REFINEMENT, args.refinement)
                   if solver == "ELMAN_triang" else args.refinement)
            prob, out, mode_errs = phase_mode(solver, ref, device)
            path_launches[solver] = out["launches"]
            errs += mode_errs
            if solver == "rational":
                time_fused(prob.kinv_stencils[0],
                           prob._kinv_gmg.levels[0].lam_max, 4, device,
                           times)
            del prob
            torch.cuda.empty_cache()
        for out in phase_rational_table(device):
            path_launches[out["path"]] = out["launches"]

        prob, out, bf16_errs = phase_bf16_flagship(
            args.refinement, device, flag["outer_iterations"])
        path_launches["augmented_bf16"] = out["launches"]
        errs += bf16_errs
        lat = tuple(reversed(prob.space.n_points_1d))
        time_k1_bf16(tuple(1.0 / (n - 1) for n in lat), lat, device, times)
        time_fused(prob.level_stencils[0], prob._last_gmg.levels[0].lam_max,
                   prob.cfg.gmg_smoother_degree, device, times)
        del prob
        torch.cuda.empty_cache()
        time_k1_levels(level_shapes, device, times)
        ref = min(REFINED_REFINEMENT, args.refinement)
        for bf16 in (False, True):
            out = phase_refined(ref, device, bf16)
            path_launches[out["path"]] = out["launches"]
            torch.cuda.empty_cache()
        print_times(times)

        out, ell_errs, ell_space = phase_elliptic(args.elliptic_cycle, device)
        path_launches[out["path"]] = out["launches"]
        errs += ell_errs
        torch.cuda.empty_cache()
        time_k6_f64(ell_space, device, times)

        for pair, sd in ((args.stokes_refinement, 2),
                         (args.stokes3d_refinement, 3)):
            out = phase_stokes(pair, sd, device)
            path_launches[out["path"]] = out["launches"]

        outs, form_errs = phase_al_forms(args.refinement, explicit_ref,
                                         device)
        errs += form_errs
        for out in outs:
            path_launches[out["path"]] = out["launches"]
        for out in (phase_nitsche(device, nitsche_cycles)
                    + phase_elasticity(device, elasticity_cycles)
                    + phase_adaptive(device)
                    + phase_adaptive_stokes(device)):
            path_launches[out["path"]] = out["launches"]
        rows, opt_errs = phase_options(device, args.refinement, explicit_ref)
        errs += opt_errs
        for out in rows:
            path_launches[out["path"]] = out["launches"]
        gc.collect()
        torch.cuda.empty_cache()
        phase_host_and_table(device, path_launches)

        phase_crosscheck(device)
        phase_elliptic_crosscheck(device)
        phase_stokes_crosscheck(device)
        phase_family_crosscheck(device)
        phase_options_crosscheck(device)
        report = kernel_report(path_launches, errs, times, resources)
        print(f"chip_smoke: all phases passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    except Exception:  # report every phase failure and exit non-zero
        traceback.print_exc()
        return 1
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
