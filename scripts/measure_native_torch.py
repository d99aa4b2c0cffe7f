#!/usr/bin/env python
"""Setup + build seconds of the port's problems with the host C++ setup
routines (``fictitious_domain_al_preconditioners_torch/native.py``) and with
their NumPy forms, at the results table's rows where setup leads.

For each row the problem is set up and solved once with each form, in turns
(the form that goes first alternates from row to row); the line printed per
run holds the setup and build seconds, the seconds spent inside each of the
four entries (``locate_points``, ``tabulate``, ``coo_dedup``,
``accumulate_al``) and their calls, and the outer count.  The NumPy forms
are reached by replacing ``native.available`` for the run, from here: the
package has no switch of its own.

    python scripts/measure_native_torch.py [ROW ...] [--device cuda|cpu]
        [--out FILE]

ROW is a key of scripts/make_results_table_torch.py (default: laplace:12,
laplace:13, elliptic:6, adaptive:flower_f1_g1:11:12, stokes:9:10).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import make_results_table_torch as mrt  # noqa: E402
import results_rows_torch as rows  # noqa: E402

ROWS = ("laplace:12", "laplace:13", "elliptic:6",
        "adaptive:flower_f1_g1:11:12", "stokes:9:10")
ENTRIES = ("locate_points", "tabulate", "coo_dedup", "accumulate_al")


def make_problem(key, device):
    from fictitious_domain_al_preconditioners_torch import models as M

    kind, arg = key.split(":", 1)
    if kind == "laplace":
        return lambda: M.ImmersedLaplaceProblem(
            rows.flagship_config(int(arg)), device=device).setup()
    if kind == "adaptive":
        return lambda: M.ImmersedLaplaceProblem(
            rows.adaptive_config(arg), device=device).setup()
    if kind == "elliptic":
        return lambda: M.EllipticInterfaceProblem(
            rows.elliptic_config(), device=device).setup(int(arg))
    if kind == "stokes":
        return lambda: M.StokesProblem(rows.stokes_config(arg, 2),
                                       device=device).setup()
    raise ValueError(f"no setup measurement for {key!r}")


def measure(key, device, form):
    """Set up and solve ``key`` once with ``form`` ("native" or "numpy");
    returns the run's line."""
    import torch
    from fictitious_domain_al_preconditioners_torch import native

    spent = {name: [0.0, 0] for name in ENTRIES}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name][0] += time.perf_counter() - t0
                spent[name][1] += 1
        return wrapper

    patches = [mock.patch.object(native, name, timed(name,
                                                     getattr(native, name)))
               for name in ENTRIES]
    if form == "numpy":
        patches.append(mock.patch.object(native, "available", lambda: False))
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    for p in patches:
        p.start()
    try:
        t0 = time.perf_counter()
        prob = make_problem(key, device)()
        setup_s = time.perf_counter() - t0
        prob.solve()
    finally:
        for p in patches:
            p.stop()
    res = prob.results
    its = res.get("outer_iterations")
    del prob
    return dict(row=key, form=form, setup_seconds=setup_s,
                build_seconds=res.get("build_seconds"),
                setup_build_seconds=setup_s + res.get("build_seconds", 0.0),
                solve_seconds=res.get("solve_seconds"), outer_iterations=its,
                entries={k: dict(seconds=v[0], calls=v[1])
                         for k, v in spent.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*", default=list(ROWS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", help="also append the lines to this file")
    args = ap.parse_args(argv)
    from fictitious_domain_al_preconditioners_torch import native

    if not native.available():
        print("measure_native_torch: no C++ compiler: nothing to compare",
              file=sys.stderr)
        return 1
    env = mrt.environment(args.device)
    print(json.dumps(env), flush=True)
    lines = []
    for i, key in enumerate(args.rows):
        forms = ("native", "numpy") if i % 2 == 0 else ("numpy", "native")
        for form in forms:
            line = measure(key, args.device, form)
            print(json.dumps(line), flush=True)
            lines.append(line)
        if args.out:
            with open(args.out, "a") as fh:
                for line in lines[-2:]:
                    fh.write(json.dumps(dict(line, **env)) + "\n")
    print("| row | form | setup [s] | build [s] | setup + build [s] | "
          "locate + tabulate [s] | accumulate_al [s] | outer its |")
    print("|---|---|---|---|---|---|---|---|")
    for ln in lines:
        e = ln["entries"]
        loc = e["locate_points"]["seconds"] + e["tabulate"]["seconds"]
        print(f"| {ln['row']} | {ln['form']} | {ln['setup_seconds']:.2f} | "
              f"{ln['build_seconds']:.2f} | {ln['setup_build_seconds']:.2f} "
              f"| {loc:.3f} | {e['accumulate_al']['seconds']:.3f} | "
              f"{ln['outer_iterations']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
