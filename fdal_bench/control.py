"""The readings that the limits of ``correct`` are set from, at a cell's own
size on the card (never part of a benchmark run):

    python3 -m fdal_bench.control --workload <cell> --seeds 12 \
        --control-seeds 3 --base-seed <n> [--out FILE]

One process sets the cell's problem up once, solves request 0 of each of
``--seeds`` seeds (``base-seed + k``) through the cell's entry and keeps
the answers; then the control: where the family's ``CONTROL`` is
``"answer"`` the first ``--control-seeds`` answers carried in the precision
below the configuration's (``lower_precision``), where it is ``"driver"``
the same seeds solved by the program with that lower precision switched
on (``control_driver``).  After the program is freed, the reference judges
every answer as a run does (``run.judge``'s numbers).  Prints one JSON
line an answer and a summary: the largest program reading and the
smallest control reading of each number."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import spec
from .traffic import Requests


def _solve_seeds(drv, cell, seeds, kind):
    out = []
    modes = cell.traffic["modes"]
    drv.set_data([1.0] + [0.0] * (len(modes) - 1))
    drv.solve()  # builds the solver
    for seed in seeds:
        w = Requests(cell.traffic, seed).weights(0)
        drv.set_data(w)
        t0 = time.perf_counter()
        answer, rec = drv.solve()
        out.append(dict(kind=kind, seed=seed, weights=w,
                        answer=tuple(a.detach().cpu() for a in answer),
                        reported=rec["reported_residual"], ok=rec["ok"],
                        outer_iterations=rec["outer_iterations"],
                        seconds=time.perf_counter() - t0))
    return out


def readings(cell, seeds, control_seeds, device) -> list:
    import torch

    fam = cell.family()
    drv = fam.Driver(cell.config, device)
    drv.setup()
    drv.prepare(cell.traffic["modes"])
    rows = _solve_seeds(drv, cell, seeds, "program")
    if fam.CONTROL == "answer":
        rows += [dict(r, kind="control", answer=fam.lower_precision(r["answer"]))
                 for r in rows if r["seed"] in control_seeds]
        del drv
    else:
        del drv
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        ctl = fam.control_driver(cell.config, device)
        ctl.setup()
        ctl.prepare(cell.traffic["modes"])
        rows += _solve_seeds(ctl, cell, control_seeds, "control")
        del ctl
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = fam.Driver.reference_class(cell.config["problem"],
                                     cell.traffic["modes"], device)
    for r in rows:
        res, thr = ref.judge(r.pop("answer"), r.pop("weights"))
        r.update(residual=res, threshold=thr, residual_ratio=res / thr,
                 residual_gap=abs(res - r["reported"]) / thr)
    return rows


def summary(rows: list) -> dict:
    out = {}
    for name in ("residual_ratio", "residual_gap"):
        prog = [r[name] for r in rows if r["kind"] == "program"]
        ctl = [r[name] for r in rows if r["kind"] == "control"]
        out[name] = dict(program_max=max(prog) if prog else None,
                         control_min=min(ctl) if ctl else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--base-seed", type=int, required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", help="also append the lines to this file")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seeds = [args.base_seed + k for k in range(args.seeds)]
    rows = readings(cell, seeds, set(seeds[:args.control_seeds]), args.device)
    lines = [json.dumps(dict(r, workload=cell.name)) for r in rows]
    lines.append(json.dumps(dict(workload=cell.name, summary=summary(rows))))
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
