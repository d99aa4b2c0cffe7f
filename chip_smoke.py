#!/usr/bin/env python3
"""Drive the PyTorch port's immersed_laplace solves on one CUDA card.

    python3 chip_smoke.py                  # all phases, refinement 12
    python3 chip_smoke.py --refinement 9   # the same at a quick size

Phases (any failure exits non-zero before the last line is printed):

1. device: require CUDA, print the card's name and power limit, build the
   kernels from ``fictitious_domain_al_preconditioners_torch/csrc``;
2. kernels against their plain PyTorch versions on the card: K1 (float32
   and its bf16-storage form), K6, and K2 in all four modes with patch
   planes (from flagship couplings) and without, at n = 65, n = 1025 and
   (530, 777);
3. the flagship solve (``bench.py``'s configuration, ``solver="augmented"``)
   at the refinement: a warm-up solve, then a timed solve, through
   ``ImmersedLaplaceProblem(cfg).setup()`` and ``.solve()``; the launch
   counters must show K1, K6 and K2 ``op``/``pre``/``post`` on that path;
   afterwards every kernel is compared with its plain version again at the
   shapes that path gave it, and timed at the fine level;
5. the ``rational`` and ``CG`` modes at the refinement and ``ELMAN_triang``
   at refinement 9 (at most the refinement), on the f = 0, g = 1 circle with
   the flagship's stopping rule, each a warm-up and a timed solve; the
   counters must show K1, K6 and K2 without patch ``pre``/``post`` on each
   path; afterwards the kernels are compared with their plain versions at
   the shapes those paths gave them, and K6 and the no-patch K2 are timed at
   the fine level (K6 also against ``torch.nn.functional.conv2d``);
6. the mixed-precision flagship: the flagship with the bf16 V-cycle
   (``use_bf16_multigrid``) at the refinement, a warm-up and a timed solve;
   it must converge within 2 outer iterations of phase 3's count, with K1's
   bf16 form launched; K1 bf16 is compared with its plain version at every
   level shape of that path and timed at the fine level; then
   ``solve_refined(tol_abs=1e-10)`` at refinement 11 (at most the
   refinement), once with the float32 V-cycle (``bench.py``'s ``refined``
   row) and once with the bf16 V-cycle, each to a true float64 residual of
   at most 1e-10;
4. cross-check at refinement 7: the card (kernels) against the CPU (plain
   versions) in float32 with the same Lanczos start vectors, for the
   flagship, the three modes and the flagship with the bf16 V-cycle.

Launch counts are set to 0 just before each path (phases 3, 5 and 6) and
read just after it.  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

PKG = "fictitious_domain_al_preconditioners_torch"
SOURCE = {"masked_laplace_2d": f"{PKG}/csrc/fdal_stencil.cu",
          "masked_laplace_2d:bf16": f"{PKG}/csrc/fdal_stencil.cu",
          "fused_augmented_2d": f"{PKG}/csrc/fdal_kernels.cu",
          "laplace_stencil_2d": f"{PKG}/csrc/fdal_stencil.cu"}
_TPU = "fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py"
REPLACES = {"masked_laplace_2d": f"{_TPU}:193",
            "masked_laplace_2d:bf16": f"{_TPU}:193",
            "fused_augmented_2d": f"{_TPU}:394",
            "laplace_stencil_2d": f"{_TPU}:31"}
# max |kernel - plain| / max |plain|: one application vs the Chebyshev
# recurrence (the bounds of tests/test_fused_cheb.py) in float32; K1's bf16
# form, where a float32 sum order can flip one bf16 rounding (2^-8)
TOL = {"masked_laplace_2d": 1e-6, "laplace_stencil_2d": 1e-6, "op": 1e-6,
       "smooth": 2e-5, "pre": 2e-5, "post": 5e-5,
       "masked_laplace_2d:bf16": 1e-2}
# the solver modes of phase 5 and the refinement of ELMAN_triang, the
# negative control whose counts grow with refinement (BASELINE.md:31)
MODE_SOLVERS = ("rational", "CG", "ELMAN_triang")
ELMAN_REFINEMENT = 9
# bench.py's refined row (REF_SMALL) and the reference configs' tolerance
REFINED_REFINEMENT = 11
REFINED_TOL = 1e-10
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
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
    check(rel <= TOL[kernel if mode == "-" else mode.split(":")[0]],
          f"{kernel}:{mode} {tag}: rel err {rel:.3e} > tol")


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


def compare_fused(st, device, lam, seed, tag, errs):
    """K2 in all four modes against its plain version on one stencil (with
    or without patch planes)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                        device=device)
    x0 = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                         device=device)
    kw = dict(lam_max=lam, degree=4, eig_ratio=30.0)
    form = "" if st.patched else ":no_patch"
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        got = K.fused_augmented_2d(mode, st, b, xin, **kw)
        ref = K.fused_augmented_2d_plain(mode, st, b, xin, **kw)
        pairs = zip(got, ref) if mode == "pre" else [(got, ref)]
        for g, r in pairs:
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
    from fictitious_domain_al_preconditioners_torch.ops.kernels import \
        AugmentedStencil2D

    errs = []
    cases = []
    for ref in (6, 10):                       # n = 65, 1025
        planes, box = flagship_planes(ref, device)
        n = 2 ** ref + 1
        cases.append((f"n={n}", (n, n), planes, box))
    # non-square and not a multiple of any tile; the box origin (48, 56)
    # sits on a tile edge of the pre/post kernels (24 x 56 output tiles)
    planes, (_, _, pr, pc) = flagship_planes(9, device)
    cases.append(("(530,777)", (530, 777), planes, (48, 56, pr, pc)))
    for i, (tag, shape, planes, box) in enumerate(cases):
        h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
        compare_stencils(h, shape, device, seed=i, tag=tag, errs=errs)
        for st in (AugmentedStencil2D(h, shape, planes, box),
                   AugmentedStencil2D(h, shape, device=device,
                                      dtype=planes.dtype)):
            lam = stencil_lam(st)
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


def phase_flagship_shapes(prob, device):
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
    print(f"phase 3: kernels agree with plain at all {len(errs)} "
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


def cuda_time_pair(fn, plain, reps=20):
    """(kernel ms, plain ms), each the median of ``reps`` CUDA-event timed
    calls, taken in turns kernel, plain, plain, kernel."""
    a1, p1 = cuda_time_ms(fn, reps // 2), cuda_time_ms(plain, reps // 2)
    p2, a2 = cuda_time_ms(plain, reps // 2), cuda_time_ms(fn, reps // 2)
    return statistics.median([a1, a2]), statistics.median([p1, p2])


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take,
    bytes over the memory rate against operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_bound(mode, st, degree):
    """Bound of one K2 call: the lattice inputs read once (b, and x0 in
    post), the outputs written once (x, and r in pre), the planes read once;
    the stencil applications, Chebyshev updates and patch terms done."""
    ny, nx = st.shape
    n = ny * nx
    box = st.box[2] * st.box[3]
    arrays = {"op": 2, "smooth": 2, "pre": 3, "post": 3}[mode]
    apps = {"op": 1, "smooth": degree - 1, "pre": degree,
            "post": degree}[mode]
    updates = 0 if mode == "op" else degree - 1
    nbytes = 4 * (arrays * n + 5 * box)
    flops = n * (apps * STENCIL_FLOPS + 6 * updates + 4) + box * apps * 18
    return bound(nbytes, flops)


def time_fused(st, lam, degree, device, times):
    """K2's modes at one stencil: kernel and plain times, and the bound."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    rng = np.random.default_rng(7)
    b = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                        device=device)
    x0 = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                         device=device)
    kw = dict(lam_max=lam, degree=degree, eig_ratio=30.0)
    form = "" if st.patched else ":no_patch"
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        ms, pms = cuda_time_pair(
            lambda: K.fused_augmented_2d(mode, st, b, xin, **kw),
            lambda: K.fused_augmented_2d_plain(mode, st, b, xin, **kw))
        times[mode + form] = dict(ms=ms, plain_ms=pms, library_ms=None,
                                  shape=list(st.shape))
        times[mode + form]["bound_ms"], times[mode + form]["bound_by"] = \
            fused_bound(mode, st, degree)


def time_stencils(h, shape, device, times):
    """K1 and K6 at one lattice: kernel, plain and bound; K6 also against
    ``conv2d`` with its 3x3 weight and ``padding=1`` (the body of
    ``_conv9_pallas``, without the edge corrections)."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    u = torch.as_tensor(np.random.default_rng(8).standard_normal(shape),
                        dtype=torch.float32, device=device)
    n = shape[0] * shape[1]
    b = bound(8 * n, STENCIL_FLOPS * n)
    ms, pms = cuda_time_pair(lambda: K.masked_laplace_2d(u, h),
                             lambda: K.masked_laplace_2d_plain(u, h))
    times["masked_laplace_2d"] = dict(ms=ms, plain_ms=pms, library_ms=None,
                                      bound_ms=b[0], bound_by=b[1],
                                      shape=list(shape))
    K0, M0, K1, M1 = K.stencil_factors_2d(h)
    w = torch.as_tensor(np.outer(K0, M1) + np.outer(M0, K1),
                        dtype=torch.float32, device=device)[None, None]
    ms, pms = cuda_time_pair(lambda: K.laplace_stencil_2d(u, h),
                             lambda: K.laplace_stencil_2d_plain(u, h))
    lib = cuda_time_ms(lambda: torch.nn.functional.conv2d(
        u[None, None], w, padding=1))
    times["laplace_stencil_2d"] = dict(ms=ms, plain_ms=pms, library_ms=lib,
                                       bound_ms=b[0], bound_by=b[1],
                                       shape=list(shape))


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
    ms, pms = cuda_time_pair(lambda: K.masked_laplace_2d(u, h),
                             lambda: K.masked_laplace_2d_plain(u, h))
    times["masked_laplace_2d:bf16"] = dict(
        ms=ms, plain_ms=pms, library_ms=None, bound_ms=b[0], bound_by=b[1],
        shape=list(shape))


def phase_bf16_flagship(refinement, device, f32_iterations):
    """The flagship with the bf16 V-cycle: converged within 2 outer
    iterations of the float32 V-cycle's count, K1 bf16 on its path and
    agreeing with its plain version at every level shape."""
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
                           launch_key("op")], "phase 6")
    errs = []
    for i, level in enumerate(prob._last_gmg.levels):
        lat = tuple(reversed(level.space.n_points_1d))
        h = tuple(1.0 / (n - 1) for n in lat)
        u = torch.as_tensor(
            np.random.default_rng(500 + i).standard_normal(lat),
            dtype=torch.float32, device=device)
        compare_k1_bf16(h, u, f"bf16 flagship level {i} {lat}", errs)
    print(f"phase 6: K1 bf16 agrees with plain at all {len(errs)} level "
          "shapes", flush=True)
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
        history=history, solve_seconds=res["solve_seconds"],
        device_seconds=res["correction_seconds"],
        host_residual_seconds=res["host_residual_seconds"],
        host_syncs=res["host_syncs"],
        warmup_seconds=warm["solve_seconds"],
        build_seconds=warm["refine_build_seconds"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
        launches=launches)
    print("phase 6: " + json.dumps(out), flush=True)
    check(res["converged"] and history[-1] <= REFINED_TOL,
          f"phase 6 {tag}: true residual {history[-1]:.3e} > {REFINED_TOL}")
    check(u.shape == (prob.space.n_dofs,) and bool(np.isfinite(u).all())
          and bool(np.isfinite(lam).all()),
          f"phase 6 {tag}: non-finite or misshapen iterate")
    require_launches(out, ["fused_augmented_2d:op", "masked_laplace_2d:bf16"
                           if bf16 else "fused_augmented_2d:pre"],
                     f"phase 6 {tag}")
    return out


def phase_crosscheck(device, refinement=7):
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops.assembly import \
        l2_error

    outs = []
    for solver in ("augmented",) + MODE_SOLVERS + ("augmented_bf16",):
        runs = {}
        for dev in (device, torch.device("cpu")):
            cfg = (flagship_config(refinement, bf16=solver.endswith("bf16"))
                   if solver.startswith("augmented")
                   else mode_config(solver, refinement))
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
        if solver.startswith("augmented"):
            out["l2_error_gpu"] = l2_error(pg.space, ug, exact_solution)
        print("phase 4: " + json.dumps(out), flush=True)
        check(cg_ and cc, f"phase 4 {solver}: a solve did not converge")
        check(abs(itg - itc) <= 1, f"phase 4 {solver}: outer counts {itg} "
              f"vs {itc}")
        check(diff <= 1e-3 * scale, f"phase 4 {solver}: |u_gpu - u_cpu| = "
              f"{diff:.3e}")
        if solver.startswith("augmented"):
            check(out["l2_error_gpu"] < 6e-3,
                  f"phase 4: L2 error {out['l2_error_gpu']:.3e}")
        outs.append(out)
    return outs


def kernel_report(path_launches, errs, times):
    """The kernels' JSON line: one entry per kernel (K1's bf16 form its own),
    K2's modes inside.  ``launches`` sums the paths of phases 3, 5 and 6
    (``launches_by_path`` lists them)."""
    from fictitious_domain_al_preconditioners_torch.ops.kernels import (
        MODES, launch_key)

    def worst(kernel, mode=None):
        return max(e[3] for e in errs if e[0] == kernel
                   and (mode is None or e[1] == mode))

    def launches(key):
        by_path = {p: n.get(key, 0) for p, n in path_launches.items()}
        return sum(by_path.values()), by_path

    def entry(name, key, t):
        total, by_path = launches(key)
        return dict(name=name, route="cuda", source=SOURCE[name],
                    replaces=REPLACES[name], launches=total,
                    launches_by_path=by_path, max_abs_err=worst(name),
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"], shape=t["shape"])

    modes = {}
    for patch in (True, False):
        for m in MODES:
            key = m if patch else f"{m}:no_patch"
            total, by_path = launches(launch_key(m, patch))
            modes[key] = dict(times[key], launches=total,
                              launches_by_path=by_path,
                              max_abs_err=worst("fused_augmented_2d", key))
    # K2's own times are those of its patched op mode; its launches sum
    # every mode and form
    k2 = entry("fused_augmented_2d", launch_key("op"), times["op"])
    k2["launches_by_path"] = {
        p: sum(n.get(launch_key(m, q), 0) for m in MODES
               for q in (True, False))
        for p, n in path_launches.items()}
    k2["launches"] = sum(k2["launches_by_path"].values())
    k2["modes"] = modes
    return {"kernels": [
        entry("masked_laplace_2d", "masked_laplace_2d",
              times["masked_laplace_2d"]),
        entry("masked_laplace_2d:bf16", "masked_laplace_2d:bf16",
              times["masked_laplace_2d:bf16"]),
        k2,
        entry("laplace_stencil_2d", "laplace_stencil_2d",
              times["laplace_stencil_2d"]),
    ]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refinement", type=int, default=12,
                    help="refinement of the flagship (float32 and bf16 "
                         "V-cycle), rational and CG solves (ELMAN_triang "
                         f"runs at min({ELMAN_REFINEMENT}, this), "
                         f"solve_refined at min({REFINED_REFINEMENT}, "
                         "this))")
    args = ap.parse_args(argv)

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

        errs = phase_kernels(device)
        path_launches, times = {}, {}
        prob, flag = phase_flagship(args.refinement, device)
        path_launches["augmented"] = flag["launches"]
        errs += phase_flagship_shapes(prob, device)
        fine = prob.level_stencils[0]
        time_stencils(fine.h, fine.shape, device, times)
        time_fused(fine, prob._last_gmg.levels[0].lam_max,
                   prob.cfg.gmg_smoother_degree, device, times)
        del prob
        torch.cuda.empty_cache()

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

        prob, out, bf16_errs = phase_bf16_flagship(
            args.refinement, device, flag["outer_iterations"])
        path_launches["augmented_bf16"] = out["launches"]
        errs += bf16_errs
        lat = tuple(reversed(prob.space.n_points_1d))
        time_k1_bf16(tuple(1.0 / (n - 1) for n in lat), lat, device, times)
        del prob
        torch.cuda.empty_cache()
        ref = min(REFINED_REFINEMENT, args.refinement)
        for bf16 in (False, True):
            out = phase_refined(ref, device, bf16)
            path_launches[out["path"]] = out["launches"]
            torch.cuda.empty_cache()
        for k, t in times.items():
            print(f"time {k} at {tuple(t['shape'])}: kernel {t['ms']:.4f} "
                  f"ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library "
                  f"{t['library_ms']} ms", flush=True)

        phase_crosscheck(device)
        report = kernel_report(path_launches, errs, times)
        print(f"chip_smoke: all phases passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    except Exception:  # report every phase failure and exit non-zero
        traceback.print_exc()
        return 1
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
