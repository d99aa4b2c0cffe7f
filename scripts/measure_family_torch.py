#!/usr/bin/env python
"""Measure several rows of ONE family of the H100 results table in one
process, into the cache of scripts/make_results_table_torch.py.

Counterpart of scripts/measure_family.py: the row functions of
results_rows_torch.py and the cache and staleness rule of
make_results_table_torch.py, without a subprocess and a fresh CUDA context
per row.  Before each row it writes a provisional entry
(``"err": "in progress"``), so that a row that kills its process leaves a
record; a row that raises is recorded as failed with its exception, and the
sweep goes on.  Every write re-reads the cache and merges into it under a
lock, so that processes measuring other rows at once keep theirs.

Usage: python scripts/measure_family_torch.py KIND ARG [ARG ...]
           [--device cuda|cpu] [--cache PATH] [--force]
           [--repeat N [--dtypes float64 float32]]
       (KIND and ARG as in make_results_table_torch.ROWSPECS, e.g.
       ``elliptic 0 1 2``; --force re-measures rows that are fresh)

``--repeat N`` (elasticity rows) writes no cache: it sets each row's
problem up once per V-cycle dtype of ``--dtypes`` and runs its
``solve_refined`` N times on it, one JSON line a call (dtype, call, outer
iterations, refine steps, true float64 residual, seconds, the card): whether
the refined count repeats from one call to the next.  As in the table, the
first call builds the correction solver and later calls reuse it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import make_results_table_torch as mrt  # noqa: E402
import results_rows_torch as rows  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=sorted(rows.FAMILY_MODEL))
    ap.add_argument("args", nargs="+")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cache", default=mrt.CACHE)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--dtypes", nargs="+", default=["float32"],
                    choices=("float64", "float32"))
    opts = ap.parse_args(argv)
    if opts.repeat:
        for arg in opts.args:
            repeat(opts.kind, arg, opts.device, opts.dtypes, opts.repeat)
        return 0
    env = None
    for arg in opts.args:
        key = f"{opts.kind}:{arg}"
        ent = mrt.load_cache(opts.cache).get(key)
        if (not opts.force and ent is not None and ent.get("row") is not None
                and not mrt.row_is_stale(opts.kind, ent)):
            print(f"{key} cached (fresh, measured {ent.get('measured')})",
                  flush=True)
            continue
        env = env or mrt.environment(opts.device)
        mrt.save_entries(opts.cache, {key: mrt.stamp(opts.kind, dict(
            row=None, err="in progress", pid=os.getpid()), env)})
        t0 = time.perf_counter()
        try:
            ent = rows.compute_row(opts.kind, arg, opts.device)
            print(f"{key} -> {ent['row']}", flush=True)
        except Exception:
            err = traceback.format_exc()
            ent = dict(row=None, err=mrt.short(err.strip().splitlines()[-1]),
                       row_seconds=time.perf_counter() - t0)
            print(f"{key} FAILED\n{err[-1200:]}", flush=True)
        mrt.save_entries(opts.cache, {key: mrt.stamp(opts.kind, ent, env)})
        gc.collect()
    return 0


def repeat(kind, arg, device, dtypes, n):
    """``--repeat``: the row's ``solve_refined`` ``n`` times per V-cycle
    dtype, each dtype on one set-up problem."""
    import torch

    from fictitious_domain_al_preconditioners_torch.models import \
        ElasticityInterfaceProblem

    if kind != "elasticity":
        raise SystemExit("--repeat: elasticity rows only")
    card = mrt.environment(device)["card"]
    for name in dtypes:
        prob = ElasticityInterfaceProblem(
            rows.elasticity_config(), device=device,
            dtype=getattr(torch, name)).setup(int(arg))
        for call in range(n):
            t0 = time.perf_counter()
            _, _, _, history = prob.solve_refined(tol_abs=1e-10)
            res = prob.results
            print(json.dumps(dict(
                key=f"{kind}:{arg}", dtype=name, call=call,
                dofs=list(prob.layout.sizes),
                outer_iterations=res["outer_iterations"],
                refine_steps=res["refine_steps"],
                refined_residual=history[-1], converged=res["converged"],
                seconds=time.perf_counter() - t0, card=card)), flush=True)
        del prob
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
