#!/usr/bin/env python3
"""Profile solves of the PyTorch port on one CUDA card: where the device
time goes.

    python3 profile_solve.py                         # augmented, rational, CG
    python3 profile_solve.py --solver rational --refinement 12
    python3 profile_solve.py --solver augmented_bf16 # bf16 V-cycle flagship

For each solver mode: set up ``chip_smoke.py``'s configuration of it
(``augmented_bf16`` is the flagship with ``use_bf16_multigrid``), run two
unprofiled solves (the first builds the solver), then one solve under
``torch.profiler`` (CPU and CUDA activities).  Prints one JSON line per mode:
the unprofiled and profiled wall times, the device time summed over the
device activities (kernels, copies, fills) and their count, the busy share
(device time over profiled wall), the host syncs, and the activities with
the most device time.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time


def profile_mode(solver, refinement, device, top):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import flagship_config, mode_config
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem

    cfg = (flagship_config(refinement, bf16=solver == "augmented_bf16")
           if solver.startswith("augmented")
           else mode_config(solver, refinement))
    prob = ImmersedLaplaceProblem(cfg, device=device).setup()
    prob.solve()
    prob.solve()
    unprofiled = prob.results["solve_seconds"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prob.solve()
        wall = time.perf_counter() - t0
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name[evt.name]
            rec[0] += evt.time_range.elapsed_us() / 1e3
            rec[1] += 1
    device_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(
        solver=solver, refinement=refinement,
        dofs_background=prob.space.n_dofs,
        outer_iterations=prob.results["outer_iterations"],
        converged=prob.results["converged"],
        host_syncs=prob.results["host_syncs"],
        unprofiled_solve_ms=unprofiled * 1e3, profiled_wall_ms=wall * 1e3,
        device_ms=device_ms, busy_share=device_ms / (wall * 1e3),
        device_activities=sum(n for _, n in by_name.values()),
        top=[dict(name=name[:120], ms=ms, calls=n, share=ms / device_ms)
             for name, (ms, n) in ranked])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--solver", nargs="+",
                    default=["augmented", "rational", "CG"],
                    choices=["augmented", "augmented_bf16", "rational", "CG",
                             "ELMAN_triang"])
    ap.add_argument("--refinement", type=int, default=12)
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
                                      args.top)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
