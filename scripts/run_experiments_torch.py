#!/usr/bin/env python
"""Batch experiment runner of the PyTorch port: runs every .prm file under a
directory through the port's CLI (``fictitious_domain_al_preconditioners_torch
/cli.py``) and writes each run's output to ``output_<name>.log`` in the
working directory, beside the files the CLI writes there
(``used_parameters.prm``, ``<name>.csv``, VTU).

Counterpart of scripts/run_experiments.py (reference:
scripts/run_experiments.sh:1-35).  The problems run on the CUDA card unless
``--device cpu`` is given.

Usage: python scripts/run_experiments_torch.py [parameters_dir]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def guess_problem(prm_text: str) -> str | None:
    """The CLI subcommand of a parameter file, from its sections."""
    if "Distributed Lagrange<1,2>" in prm_text:
        if "IBStokes" in prm_text or "Velocity space" in prm_text:
            return "stokes"
        return "immersed_laplace"
    if "Distributed Lagrange<2,3>" in prm_text:
        return "stokes3d"
    if "Elliptic Interface Problem" in prm_text:
        if "lambda background" in prm_text:
            return "elasticity"
        return "elliptic_interface"
    if "Nitsche Lagrange" in prm_text:
        return "nitsche_bcs"
    return None


def main(argv=None):
    from fictitious_domain_al_preconditioners_torch import cli

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default="parameters")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    files = sorted(glob.glob(os.path.join(args.root, "**", "*.prm"),
                             recursive=True))
    if not files:
        print(f"no .prm files under {args.root}")
        return 1
    failed = 0
    for f in files:
        with open(f) as fh:
            text = fh.read()
        problem = guess_problem(text) if text.strip() else None
        if problem is None:
            print(f"-- skipping {f} (unknown problem type)")
            continue
        name = os.path.splitext(os.path.basename(f))[0]
        log = f"output_{name}.log"
        print(f"== {problem}: {f} -> {log}", flush=True)
        t0 = time.perf_counter()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                if problem in ("stokes", "stokes3d"):
                    cli.run_stokes(f, args.device,
                                   spacedim=3 if problem == "stokes3d"
                                   else 2)
                else:
                    cli.COMMANDS[problem](f, args.device)
        except Exception as exc:
            buf.write(f"\nFAILED: {exc}\n")
            failed += 1
        with open(log, "w") as fh:
            fh.write(buf.getvalue())
        print(f"   done in {time.perf_counter() - t0:.1f}s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
