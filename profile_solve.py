#!/usr/bin/env python3
"""Profile solves of the PyTorch port on one CUDA card: where the device
time goes.

    python3 profile_solve.py                         # augmented, rational, CG
    python3 profile_solve.py --solver rational --refinement 12
    python3 profile_solve.py --solver augmented_bf16 # bf16 V-cycle flagship
    python3 profile_solve.py --solver refined        # solve_refined at 11
    python3 profile_solve.py --solver elliptic_refined --elliptic-cycle 6
    python3 profile_solve.py --solver stokes stokes_refined \
        --stokes-refinement 9:10
    python3 profile_solve.py --solver explicit nitsche nitsche_refined \
        elasticity elasticity_refined --nitsche-cycle 7 --elasticity-cycle 2
    python3 profile_solve.py --solver adaptive adaptive_f64 \
        adaptive_stokes_refined

For each solver mode: set up ``chip_smoke.py``'s configuration of it
(``augmented_bf16`` is the flagship with ``use_bf16_multigrid``; ``refined``
is the flagship's ``solve_refined(tol_abs=1e-10)`` at refinement 11, or
``--refinement`` if that is less; ``elliptic`` and ``elliptic_refined`` are
the elliptic interface problem's ``solve()`` and
``solve_refined(tol_abs=1e-10)`` in ``chip_smoke.py``'s configuration at
``--elliptic-cycle``; ``stokes`` and ``stokes_refined`` the 2D Stokes
problem's ``solve()`` and ``solve_refined(tol_abs=1e-8)`` in its
configuration at ``--stokes-refinement``; ``explicit`` the flagship in the
explicit AL form with W = diag(M)² at refinement 11, or ``--refinement``
if that is less; ``nitsche``/``nitsche_refined`` and
``elasticity``/``elasticity_refined`` the nitsche and 3D elasticity
problems in ``chip_smoke.py``'s configurations at ``--nitsche-cycle`` and
``--elasticity-cycle``, ``solve()`` and ``solve_refined(tol_abs=1e-10)``;
``adaptive`` and ``adaptive_f64`` ``chip_smoke.py`` phase 12's flower with
one local refinement step at its pair (10, 11) (float32 under the
flagship's rule, float64 at the file's), ``adaptive_stokes_refined`` the 2D
Stokes problem's ``solve_refined`` at ``--stokes-refinement`` with one
local step), run two unprofiled solves (the
first builds the solver), then one solve under ``torch.profiler`` (CPU and
CUDA activities).  Prints one JSON line per mode: the unprofiled and profiled wall
times, the device time summed over the device activities (kernels, copies,
fills) and their count, the busy share (device time over profiled wall), the
host syncs, the device ms and calls of each of the port's own kernels
(``port_kernels``), and the activities with the most device time.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import time

_SWEEP = re.compile(r"sweep_kernel<(?:\(int\))?(\d), (?:\(int\))?\d, "
                    r"(?:\(bool\))?(true|false|1|0), (float|__nv_bfloat16)>")


def port_kernel(name):
    """The port's kernel that a device activity's name belongs to (K1 by
    storage form, K2 by mode, form and storage form, K6 by dtype form), or
    None."""
    if "augmented_op_kernel" in name:
        return "K2 op"
    if "laplace_stencil_kernel" in name:
        return "K6 float64" if "double" in name else "K6 float32"
    if "masked_laplace_kernel" in name:
        return "K1 bf16" if "bfloat16" in name else "K1 float32"
    m = _SWEEP.search(name)
    if m:
        mode = ("op", "smooth", "pre", "post")[int(m.group(1))]
        patch = m.group(2) in ("true", "1")
        return (f"K2 {mode}" + ("" if patch else ", no patch")
                + (" bf16" if m.group(3) != "float" else ""))
    return None


def profile_mode(solver, refinement, device, top, elliptic_cycle,
                 stokes_pair, nitsche_cycle=4, elasticity_cycle=2):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (ADAPTIVE_PAIR, ADAPTIVE_SCALE_FILE,
                            EXPLICIT_REFINEMENT, REFINED_REFINEMENT,
                            REFINED_TOL, STOKES_TOL,
                            adaptive_config, al_form_config,
                            elasticity_config, elliptic_config,
                            flagship_config, mode_config, nitsche_config,
                            stokes_config)
    from fictitious_domain_al_preconditioners_torch.models import (
        ElasticityInterfaceProblem, EllipticInterfaceProblem,
        ImmersedLaplaceProblem, NitscheProblem, StokesProblem)

    elliptic = solver.startswith("elliptic")
    stokes = "stokes" in solver
    nitsche = solver.startswith("nitsche")
    elasticity = solver.startswith("elasticity")
    if solver == "refined":
        refinement = min(refinement, REFINED_REFINEMENT)
    if solver == "explicit":
        refinement = min(refinement, EXPLICIT_REFINEMENT)
    if nitsche:
        refinement = nitsche_cycle
        prob = NitscheProblem(nitsche_config(),
                              device=device).setup(nitsche_cycle)
    elif elasticity:
        refinement = elasticity_cycle
        prob = ElasticityInterfaceProblem(
            elasticity_config(), device=device).setup(elasticity_cycle)
    elif stokes:
        refinement = stokes_pair
        cfg = stokes_config(stokes_pair)
        cfg.delta_refinement = int(solver.startswith("adaptive"))
        prob = StokesProblem(cfg, device=device).setup()
    elif solver.startswith("adaptive"):
        refinement = ADAPTIVE_PAIR
        f32 = solver == "adaptive"
        prob = ImmersedLaplaceProblem(
            adaptive_config(ADAPTIVE_SCALE_FILE,
                            tuple(int(x) for x in ADAPTIVE_PAIR.split(":")),
                            flagship_rule=f32),
            device=device,
            dtype=torch.float32 if f32 else torch.float64).setup()
    elif elliptic:
        refinement = elliptic_cycle
        prob = EllipticInterfaceProblem(elliptic_config(),
                                        device=device).setup(elliptic_cycle)
    else:
        if solver == "explicit":
            cfg = al_form_config(refinement, "explicit")
        elif solver.startswith("augmented") or solver == "refined":
            cfg = flagship_config(refinement,
                                  bf16=solver == "augmented_bf16")
        else:
            cfg = mode_config(solver, refinement)
        prob = ImmersedLaplaceProblem(cfg, device=device).setup()
    refined = solver.endswith("refined")
    seconds_key = "refined_seconds" if refined else "solve_seconds"

    def solve():
        if refined:
            prob.solve_refined(tol_abs=STOKES_TOL if stokes
                               else REFINED_TOL)
        else:
            prob.solve()

    solve()
    solve()
    unprofiled = prob.results[seconds_key]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        wall = time.perf_counter() - t0
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name[evt.name]
            rec[0] += evt.time_range.elapsed_us() / 1e3
            rec[1] += 1
    device_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    ours = collections.defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_name.items():
        key = port_kernel(name)
        if key:
            ours[key][0] += ms
            ours[key][1] += n
    return dict(
        solver=solver, refinement=refinement,
        dofs_background=(prob.results["dofs_background"]
                         if stokes or elasticity else prob.space.n_dofs),
        outer_iterations=prob.results.get("outer_iterations",
                                          prob.results.get("outer_its")),
        refine_steps=prob.results.get("refine_steps"),
        converged=prob.results["converged"],
        host_syncs=prob.results["host_syncs"],
        unprofiled_solve_ms=unprofiled * 1e3, profiled_wall_ms=wall * 1e3,
        device_ms=device_ms, busy_share=device_ms / (wall * 1e3),
        device_activities=sum(n for _, n in by_name.values()),
        port_kernels={k: dict(ms=ms, calls=n)
                      for k, (ms, n) in sorted(ours.items())},
        top=[dict(name=name[:120], ms=ms, calls=n, share=ms / device_ms)
             for name, (ms, n) in ranked])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--solver", nargs="+",
                    default=["augmented", "rational", "CG"],
                    choices=["augmented", "augmented_bf16", "refined",
                             "rational", "CG", "ELMAN_triang", "elliptic",
                             "elliptic_refined", "stokes",
                             "stokes_refined", "explicit", "nitsche",
                             "nitsche_refined", "elasticity",
                             "elasticity_refined", "adaptive",
                             "adaptive_f64", "adaptive_stokes_refined"])
    ap.add_argument("--refinement", type=int, default=12)
    ap.add_argument("--elliptic-cycle", type=int, default=6,
                    help="cycle of the elliptic modes")
    ap.add_argument("--stokes-refinement", default="9:10",
                    help="background:immersed refinements of the Stokes "
                         "modes")
    ap.add_argument("--nitsche-cycle", type=int, default=4,
                    help="cycle of the nitsche modes")
    ap.add_argument("--elasticity-cycle", type=int, default=2,
                    help="cycle of the elasticity modes")
    ap.add_argument("--top", type=int, default=12,
                    help="device activities listed per mode")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_solve: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"card {smi}", flush=True)
    device = torch.device("cuda", 0)
    for solver in args.solver:
        print(json.dumps(profile_mode(solver, args.refinement, device,
                                      args.top, args.elliptic_cycle,
                                      args.stokes_refinement,
                                      args.nitsche_cycle,
                                      args.elasticity_cycle)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
