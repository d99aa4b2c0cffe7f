#!/usr/bin/env python3
"""Drive the PyTorch port's flagship AL solve on one CUDA card.

    python3 chip_smoke.py            # all phases, flagship at refinement 12

Phases (any failure exits non-zero before the last line is printed):

1. device: require CUDA, print the card's name and power limit, build the
   kernels from ``fictitious_domain_al_preconditioners_torch/csrc``;
2. kernels against their plain PyTorch versions on the card (float32): K1
   and K2 in all four modes at n = 65, n = 1025 and (530, 777), with patch
   planes from flagship couplings;
3. the flagship solve (``bench.py``'s configuration) at refinement 12: a
   warm-up solve, then a timed solve, through
   ``ImmersedLaplaceProblem(cfg, device="cuda").setup()`` and ``.solve()``;
   the launch counters must show K1 and K2 ``op``/``pre``/``post`` on that
   path; afterwards every kernel is compared with its plain version again at
   the shapes that path gave it, and timed at the fine level;
4. cross-check at refinement 7: the card (kernels) against the CPU (plain
   versions) in float32 with the same Lanczos start vectors.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
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
SOURCE = f"{PKG}/csrc/fdal_kernels.cu"
REPLACES = {
    "masked_laplace_2d":
        "fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py:193",
    "fused_augmented_2d":
        "fictitious_domain_al_preconditioners_tpu/ops/pallas_kernels.py:394",
}
# max |kernel - plain| / max |plain| (float32): one application vs the
# Chebyshev recurrence (the bounds of tests/test_fused_cheb.py)
TOL = {"masked_laplace_2d": 1e-6, "op": 1e-6, "smooth": 2e-5, "pre": 2e-5,
       "post": 5e-5}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def flagship_config(refinement):
    """``bench.py``'s flagship configuration (bench.py:48-62)."""
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
    )
    cfg.schur.tolerance = 3e-5
    cfg.schur.reduction = 1e-6
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


def compare_kernels(st, device, lam, seed, tag, errs):
    """K1 and K2 (all modes) against their plain versions on one lattice;
    appends ``(kernel, mode, tag, abs_err, rel_err)`` to ``errs``."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                        device=device)
    x0 = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                         device=device)

    def record(kernel, mode, got, ref):
        got, ref = got.double(), ref.double()
        check(bool(torch.isfinite(got).all()), f"{kernel}:{mode} {tag}: "
              "non-finite output")
        abs_err = float((got - ref).abs().max())
        rel = abs_err / max(float(ref.abs().max()), 1e-300)
        errs.append((kernel, mode, tag, abs_err, rel))
        check(rel <= TOL[mode if kernel != "masked_laplace_2d" else kernel],
              f"{kernel}:{mode} {tag}: rel err {rel:.3e} > tol")

    record("masked_laplace_2d", "-", K.masked_laplace_2d(b, st.h),
           K.masked_laplace_2d_plain(b, st.h))
    kw = dict(lam_max=lam, degree=4, eig_ratio=30.0)
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        got = K.fused_augmented_2d(mode, st, b, xin, **kw)
        ref = K.fused_augmented_2d_plain(mode, st, b, xin, **kw)
        if mode == "pre":
            record("fused_augmented_2d", "pre", got[0], ref[0])
            record("fused_augmented_2d", "pre", got[1], ref[1])
        else:
            record("fused_augmented_2d", mode, got, ref)


def stencil_lam(st):
    """Lanczos bound of D⁻¹A for a stencil (plain operator)."""
    from fictitious_domain_al_preconditioners_torch.ops.krylov import \
        lanczos_max_eig

    shape = st.shape

    def mv(v):
        return (st.dinv * st.op_plain(v.reshape(shape))).reshape(-1)

    return lanczos_max_eig(mv, shape[0] * shape[1], steps=10,
                           dtype=st.planes.dtype, device=st.planes.device)


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
    for tag, shape, planes, box in cases:
        h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
        st = AugmentedStencil2D(h, shape, planes, box)
        lam = stencil_lam(st)
        compare_kernels(st, device, lam, seed=len(errs), tag=tag, errs=errs)
        print(f"phase 2: {tag} box={tuple(box)} lam_max={lam:.6f} ok",
              flush=True)
    return errs


def phase_flagship(refinement, device):
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    prob = ImmersedLaplaceProblem(flagship_config(refinement),
                                  device=device).setup()
    setup_s = time.perf_counter() - t0
    prob.solve()                                          # warm-up
    warm = dict(prob.results)
    u, lam, info = prob.solve()                           # timed
    launches = dict(K.LAUNCHES)
    res = prob.results
    dofs = prob.space.n_dofs
    cres = prob.constraint_residual()
    out = dict(
        refinement=refinement, dofs_background=dofs,
        dofs_immersed=prob.imm_space.n_dofs, setup_seconds=setup_s,
        build_seconds=warm["build_seconds"],
        warmup_solve_seconds=warm["solve_seconds"],
        outer_iterations=res["outer_iterations"],
        converged=res["converged"], residual=res["residual"],
        constraint_residual=cres, solve_seconds=res["solve_seconds"],
        mdof_iter_per_s=dofs * max(res["outer_iterations"], 1)
        / res["solve_seconds"] / 1e6,
        host_syncs=res["host_syncs"],
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
        launches=launches)
    print("phase 3: " + json.dumps(out), flush=True)
    check(res["converged"], "phase 3: flagship solve did not converge")
    check(math.isfinite(cres), "phase 3: constraint residual not finite")
    check(tuple(u.shape) == (dofs,) and bool(torch.isfinite(u).all()),
          "phase 3: solution has the wrong shape or non-finite values")
    check(launches["masked_laplace_2d"] > 0, "phase 3: K1 never launched")
    for mode in ("op", "pre", "post"):
        check(launches[f"fused_augmented_2d:{mode}"] > 0,
              f"phase 3: K2 {mode} never launched")
    return prob, out


def phase_path_shapes(prob, device):
    """Every kernel against its plain version at the shapes the flagship
    path gave it, with that path's planes and Lanczos bounds."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    errs = []
    for i, (level, st) in enumerate(zip(prob._last_gmg.levels,
                                        prob.level_stencils)):
        if st is not None:
            compare_kernels(st, device, level.lam_max, seed=100 + i,
                            tag=f"level {i} {st.shape}", errs=errs)
            continue
        lat = tuple(reversed(level.space.n_points_1d))
        h = tuple(1.0 / (n - 1) for n in lat)
        rng = np.random.default_rng(100 + i)
        b = torch.as_tensor(rng.standard_normal(lat), dtype=torch.float32,
                            device=device)
        got, ref = K.masked_laplace_2d(b, h), K.masked_laplace_2d_plain(b, h)
        abs_err = float((got - ref).abs().max())
        rel = abs_err / float(ref.abs().max())
        errs.append(("masked_laplace_2d", "-", f"level {i} {lat}", abs_err,
                     rel))
        check(rel <= TOL["masked_laplace_2d"],
              f"K1 level {i}: rel err {rel:.3e}")
    print(f"phase 3: kernels agree with plain at all {len(errs)} "
          "path comparisons", flush=True)
    return errs


def time_kernels(prob, device):
    """Kernel and plain times at the fine level of the flagship path."""
    import torch
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    st = prob.level_stencils[0]
    lam = prob._last_gmg.levels[0].lam_max
    rng = np.random.default_rng(7)
    b = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                        device=device)
    x0 = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                         device=device)
    kw = dict(lam_max=lam, degree=prob.cfg.gmg_smoother_degree,
              eig_ratio=30.0)
    times = {"masked_laplace_2d": (
        cuda_time_ms(lambda: K.masked_laplace_2d(b, st.h)),
        cuda_time_ms(lambda: K.masked_laplace_2d_plain(b, st.h)))}
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        times[mode] = (
            cuda_time_ms(lambda: K.fused_augmented_2d(mode, st, b, xin,
                                                      **kw)),
            cuda_time_ms(lambda: K.fused_augmented_2d_plain(mode, st, b, xin,
                                                            **kw)))
    for k, (ms, pms) in times.items():
        print(f"time {k} at {st.shape}: kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms", flush=True)
    return times


def phase_crosscheck(device, refinement=7):
    import torch
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem
    from fictitious_domain_al_preconditioners_torch.ops.assembly import \
        l2_error

    runs = {}
    for dev in (device, torch.device("cpu")):
        prob = ImmersedLaplaceProblem(flagship_config(refinement), device=dev,
                                      dtype=torch.float32).setup()
        u, _, info = prob.solve()
        runs[dev.type] = (u.cpu().double(), int(info.iterations),
                          bool(info.converged), prob)
    ug, itg, cg_, pg = runs["cuda"]
    uc, itc, cc, _ = runs["cpu"]
    diff = float((ug - uc).abs().max())
    scale = float(uc.abs().max())
    l2 = l2_error(pg.space, ug, exact_solution)
    out = dict(refinement=refinement, iterations_gpu=itg, iterations_cpu=itc,
               converged=(cg_, cc), max_abs_diff=diff, max_abs_cpu=scale,
               l2_error_gpu=l2)
    print("phase 4: " + json.dumps(out), flush=True)
    check(cg_ and cc, "phase 4: a cross-check solve did not converge")
    check(abs(itg - itc) <= 1, f"phase 4: outer counts {itg} vs {itc}")
    check(diff <= 1e-3 * scale, f"phase 4: |u_gpu - u_cpu| = {diff:.3e}")
    check(l2 < 6e-3, f"phase 4: L2 error {l2:.3e}")
    return out


def kernel_report(launches, errs, times):
    """The kernels' JSON line: one entry per kernel, K2's modes inside."""
    def worst(kernel, mode=None):
        return max(e[3] for e in errs if e[0] == kernel
                   and (mode is None or e[1] == mode))

    modes = {m: {"launches": launches[f"fused_augmented_2d:{m}"],
                 "max_abs_err": worst("fused_augmented_2d", m),
                 "ms": times[m][0], "plain_ms": times[m][1]}
             for m in ("op", "smooth", "pre", "post")}
    return {"kernels": [
        {"name": "masked_laplace_2d", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["masked_laplace_2d"],
         "launches": launches["masked_laplace_2d"],
         "max_abs_err": worst("masked_laplace_2d"),
         "ms": times["masked_laplace_2d"][0],
         "plain_ms": times["masked_laplace_2d"][1]},
        {"name": "fused_augmented_2d", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["fused_augmented_2d"],
         "launches": sum(m["launches"] for m in modes.values()),
         "max_abs_err": worst("fused_augmented_2d"),
         "ms": times["op"][0], "plain_ms": times["op"][1],
         "modes": modes},
    ]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refinement", type=int, default=12,
                    help="refinement of the flagship solve (phase 3)")
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
        prob, flag = phase_flagship(args.refinement, device)
        errs += phase_path_shapes(prob, device)
        times = time_kernels(prob, device)
        del prob
        torch.cuda.empty_cache()
        phase_crosscheck(device)
        report = kernel_report(flag["launches"], errs, times)
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
