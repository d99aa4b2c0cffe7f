#!/usr/bin/env python
"""The row-block sharded flagship solve of the PyTorch port at full size,
held to the serial solve: the counterpart of ``scripts/run_sharded_big.py``.

This process solves the flagship problem (``bench.py``'s circle,
``augmented``, operator form, W = diag(M), the outer rule 3e-5 / reduction
1e-6) serially (``parallel.dryrun.serial_reference``); then, for each world
size of ``--ranks``, the ranks (``parallel.mesh.launch``) set up the same
problem, build ``build_sharded_solver`` and solve once, both with
deterministic algorithms.  ``parallel.dryrun.compare_to_serial`` holds each
run to the serial solve, as ``chip_smoke.py`` phase 16 does: the outer
count, u and one application of the fine operator and of the V-cycle to a
seeded vector, within ``parallel.dryrun.SERIAL_LIMITS``.  Each run's
counts, drifts and their limits, seconds (setup, build, solve per rank;
serial), collectives and halo bytes a solve, peak GB and kernel launches
per rank go to one JSON file with the card's name and power limit.

    python scripts/run_sharded_big_torch.py [--refinement 12] [--ranks 1 2]
        [--backend auto|nccl|gloo] [--device cuda|cpu]
        [--out tables/multichip_h100.json]

``--backend auto`` takes ``nccl`` when every rank has a card of its own
(ranks <= cards) and ``gloo`` otherwise (several ranks on one card: halos
staged through the host; on the CPU, gloo).  It exits non-zero when a run
fails or leaves those limits.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or
    ``none``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"none ({exc})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "none"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--refinement", type=int, default=12)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(ROOT, "tables",
                                                  "multichip_h100.json"))
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds a run's ranks may take")
    args = ap.parse_args(argv)

    import torch

    from fictitious_domain_al_preconditioners_torch.parallel.dryrun import (
        compare_to_serial, flagship_config, serial_reference,
        sharded_flagship_rank)
    from fictitious_domain_al_preconditioners_torch.parallel.mesh import \
        launch

    cfg = flagship_config(args.refinement, tolerance=3e-5, reduction=1e-6)
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    if args.device == "cuda":
        from fictitious_domain_al_preconditioners_torch.ops.kernels import \
            build

        build()                 # once, before the ranks start
    report = dict(card=card(), torch=torch.__version__,
                  cuda=torch.version.cuda, refinement=args.refinement,
                  device=args.device, cards=cards, runs=[])
    print(f"card {report['card']}; torch {torch.__version__}", flush=True)

    serial = serial_reference(cfg, args.device)
    report["serial"] = {k: v for k, v in serial.items()
                        if k not in ("u", "probe")}
    print("serial " + json.dumps(report["serial"]), flush=True)
    if args.device == "cuda":
        torch.cuda.empty_cache()

    ok = True
    for ranks in args.ranks:
        backend = args.backend
        if backend == "auto":
            backend = "nccl" if 0 < ranks <= cards else "gloo"
        where = "cuda" if backend == "nccl" else (
            "cuda:0" if args.device == "cuda" else "cpu")
        t0 = time.perf_counter()
        try:
            res = launch(sharded_flagship_rank, ranks, backend=backend,
                         device=where, args=(cfg,), timeout=args.timeout)
        except (RuntimeError, TimeoutError) as exc:
            run = dict(world_size=ranks, backend=backend, failed=str(exc))
            report["runs"].append(run)
            print(f"ranks {ranks} ({backend}) failed:\n{exc}", flush=True)
            ok = False
            continue
        r0 = res[0]
        cmp = compare_to_serial(res, serial)
        run = dict(
            world_size=ranks, backend=backend, transport=r0["transport"],
            outer_iterations=r0["iterations"],
            serial_outer_iterations=report["serial"]["outer_iterations"],
            converged=r0["converged"], residual=r0["residual"],
            drifts=cmp["drifts"], limits=cmp["limits"],
            failures=cmp["failures"], wall_seconds=time.perf_counter() - t0,
            halo_bytes_a_solve=sum(r["counts"]["halo_bytes"] for r in res),
            ranks=[{k: r[k] for k in (
                "rank", "device", "rows", "distributed_levels", "levels",
                "compact_levels", "setup_seconds", "build_seconds",
                "solve_seconds", "host_syncs", "counts", "peak_gb",
                "launches")} for r in res])
        report["runs"].append(run)
        print(json.dumps(run), flush=True)
        ok &= not cmp["failures"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
