#!/usr/bin/env python
"""Generate tables/results_h100.md: outer iteration counts against dofs
(h-independence) and wall-clock of the PyTorch port on one CUDA card.

Counterpart of scripts/make_results_table.py: the same rows (``ROWSPECS``),
the same configuration and stopping rule per row (their functions are in
scripts/results_rows_torch.py), the same columns and
formatters with their integrity marks, and two columns more, each row's
setup + build seconds and its peak device memory.  Sections the TPU table
lacks: the locally refined rows, elasticity cycle 3, the elliptic γ study
and a convergence study.

    python scripts/make_results_table_torch.py                 # every row
    python scripts/make_results_table_torch.py --rows laplace:7,laplace:8
    python scripts/make_results_table_torch.py --render        # cache only
    python scripts/make_results_table_torch.py --row laplace:7 # one row here

Each row runs in a subprocess of its own (a clean peak-memory reading, the
card freed between rows) under a time limit (``--row-timeout``, 1,800 s): a
row that reaches it or dies is recorded as a cut, with its limit and its
last printed line, and stays in the table.  Rows are cached in
``tables/.results_h100_rows.json`` (``--cache``), each with a hash of the
files that produce it (the port's package but for the other families' model
files and ``cli.py``, and results_rows_torch.py): a row whose files changed
is re-measured, or marked † while it stands.  ``--merge FILE`` adds the
entries of another cache (a card run's) first.  The problems run on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import fcntl
import functools
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from results_rows_torch import FAMILY_MODEL, compute_row  # noqa: E402

PKG = "fictitious_domain_al_preconditioners_torch"
CACHE = os.path.join(ROOT, "tables", ".results_h100_rows.json")
TABLE = os.path.join(ROOT, "tables", "results_h100.md")
ROW_TIMEOUT_S = 1800.0

# the rows of scripts/make_results_table.py:307-327 in its order, then the
# sections the TPU table lacks
ROWSPECS = [
    ("elliptic", "0"), ("elliptic", "1"), ("elliptic", "2"),
    ("elliptic", "3"), ("elliptic", "4"), ("elliptic", "5"),
    ("elliptic", "6"),
    ("stokes", "4:5"), ("stokes", "5:6"), ("stokes", "6:7"),
    ("stokes", "7:8"), ("stokes", "8:9"), ("stokes", "9:10"),
    ("nitsche", "0"), ("nitsche", "1"), ("nitsche", "2"),
    ("nitsche", "3"), ("nitsche", "4"),
    ("elasticity", "0"), ("elasticity", "1"), ("elasticity", "2"),
    ("stokes3d", "3:0"), ("stokes3d", "4:1"), ("stokes3d", "5:2"),
    ("laplace", "7"), ("laplace", "8"), ("laplace", "9"), ("laplace", "10"),
    ("laplace", "11"), ("laplace", "12"), ("laplace", "13"),
    ("refined", "9"), ("refined", "10"),
    ("rational", "5"), ("rational", "6"), ("rational", "7"),
    ("rational", "8"), ("rational", "9"),
    ("adaptive", "circle_f0_g1:10:11"), ("adaptive", "flower_f1_g1:10:11"),
    ("adaptive", "square_f1_g1:10:11"), ("adaptive", "flower_f1_g1:11:12"),
    ("adaptive_stokes", "9:10"), ("adaptive_stokes3d", "6:4"),
    ("gamma_study", "100"), ("convergence_study", "3"),
    ("elasticity", "3"),
]

# -- cache -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def source_hash(kind):
    """Hash of the files that produce a row of ``kind``: every file of the
    port's package but ``cli.py`` and the other families' model files, and
    ``scripts/results_rows_torch.py``."""
    own = f"{PKG}/models/{FAMILY_MODEL[kind]}"
    files = ["scripts/results_rows_torch.py"]
    for base, dirs, names in os.walk(os.path.join(ROOT, PKG)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(names):
            rel = os.path.relpath(os.path.join(base, name), ROOT)
            if not name.endswith((".py", ".cu", ".cuh", ".cpp")):
                continue
            if rel == f"{PKG}/cli.py" or (rel.startswith(f"{PKG}/models/")
                                          and not rel.endswith("__init__.py")
                                          and rel != own):
                continue
            files.append(rel)
    digest = hashlib.sha1()
    for rel in sorted(files):
        with open(os.path.join(ROOT, rel), "rb") as fh:
            digest.update(rel.encode() + b"\0" + fh.read())
    return digest.hexdigest()[:12]


def row_is_stale(kind, entry):
    return entry.get("source") != source_hash(kind)


def load_cache(path):
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


@contextlib.contextmanager
def _locked(path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def save_entries(path, entries):
    """Merge ``entries`` ({key: entry}) into the cache file under a lock on
    a side file: re-read it, update, write a temporary file and replace, so
    that processes writing other rows at once keep theirs."""
    with _locked(path):
        cache = load_cache(path)
        cache.update(entries)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(cache, fh, indent=0, sort_keys=True)
        os.replace(tmp, path)


def environment(device):
    """The card (``nvidia-smi`` name and power limit), torch and CUDA
    versions, to stamp on every entry."""
    import torch

    card = "cpu"
    if torch.device(device).type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    return dict(device=str(device), card=card, torch=torch.__version__,
                cuda=torch.version.cuda)


def stamp(kind, entry, env):
    return dict(entry, source=source_hash(kind), measured=time.strftime(
        "%Y-%m-%d %H:%M:%S UTC", time.gmtime()), **env)


def short(text, limit=160):
    """``text`` cut to ``limit`` characters on a word boundary, with an
    ellipsis where it was cut."""
    text = " ".join(str(text).split())
    if len(text) <= limit:
        return text
    cut = text[:limit - 1]
    if " " in cut:
        cut = cut[:cut.rindex(" ")]
    return cut.rstrip(" ,;:") + "…"


# -- orchestration -----------------------------------------------------------

def run_row_subprocess(kind, arg, device, timeout):
    """Run one row in a subprocess under ``timeout`` seconds, echoing its
    output; returns its cache entry (the row, or a cut with the limit, the
    exit code and the last printed line)."""
    key = f"{kind}:{arg}"
    cmd = [sys.executable, os.path.abspath(__file__), "--row", key,
           "--device", device]
    lines, t0 = [], time.perf_counter()
    with open(os.devnull, "w") as null:
        with tempfile.TemporaryFile(mode="w+") as err:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                    stdin=null, text=True, cwd=ROOT)

            def pump():
                for line in proc.stdout:
                    lines.append(line.rstrip("\n"))
                    print(f"  {line}", end="", flush=True)

            reader = threading.Thread(target=pump, daemon=True)
            reader.start()
            try:
                proc.wait(timeout=timeout)
                reason = None
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                reason = "limit"
            reader.join(timeout=10)
            err.seek(0)
            stderr = err.read()
    seconds = time.perf_counter() - t0
    rows = [line for line in lines if line.startswith("ROW ")]
    if reason is None and proc.returncode == 0 and rows:
        return json.loads(rows[-1][4:])
    printed = [line for line in lines if not line.startswith("ROW ")]
    tail = [line for line in stderr.splitlines() if line.strip()]
    return dict(row=None, cut=dict(
        reason=reason or "died", limit=timeout, seconds=seconds,
        rc=proc.returncode, last_line=short(printed[-1]) if printed else "",
        error=short(tail[-1]) if tail else ""))


def orchestrate(device, cache, keys, timeout=ROW_TIMEOUT_S):
    """Measure each row of ``keys`` ("kind:arg") that is not fresh in the
    cache, one subprocess each, and merge it into the cache."""
    env = None
    for key in keys:
        kind, arg = key.split(":", 1)
        ent = load_cache(cache).get(key)
        if (ent is not None and ent.get("row") is not None
                and not row_is_stale(kind, ent)):
            print(f"{key} cached (fresh, measured {ent.get('measured')})",
                  flush=True)
            continue
        env = env or environment(device)
        print(f"{key} ...", flush=True)
        ent = run_row_subprocess(kind, arg, device, timeout)
        save_entries(cache, {key: stamp(kind, ent, env)})
        print(f"{key} -> " + (json.dumps(ent["row"]) if ent["row"]
                              is not None else json.dumps(ent["cut"])),
              flush=True)


# -- rendering (scripts/make_results_table.py:249-300) -----------------------

def _res_cell(res, conv=True):
    """Residual cell with integrity marks: non-finite -> 'diverged',
    unconverged -> an explicit annotation."""
    if res is None or not math.isfinite(res):
        return "**diverged**"
    cell = f"{res:.1e}"
    if not conv:
        cell += " **(unconverged)**"
    return cell


def fmt(rows):
    out = ["| DoF (background) | DoF (immersed) | outer iterations | solve [s] | constraint residual |",
           "|---|---|---|---|---|"]
    for n, m, it, dt, cr in rows:
        out.append(f"| {n:,} | {m:,} | {it} | {dt:.3f} | {_res_cell(cr)} |")
    return "\n".join(out)


def fmt_refined(rows):
    out = ["| DoF (background) | DoF (immersed) | total outer its | refine steps | true f64 residual | wall [s] |",
           "|---|---|---|---|---|---|"]
    for row in rows:
        n, m, it, ks, res, dt = row[:6]
        conv = bool(row[6]) if len(row) > 6 else True
        out.append(f"| {n:,} | {m:,} | {it} | {ks} | {_res_cell(res, conv)} "
                   f"| {dt:.2f} |")
    return "\n".join(out)


def fmt_nitsche(rows):
    out = ["| DoF (bulk) | DoF (multiplier) | total outer its | refine steps | true f64 residual | wall [s] | inner CG / outer |",
           "|---|---|---|---|---|---|---|"]
    for n, m, it, ks, res, dt, conv, icpo in rows:
        out.append(f"| {n:,} | {m:,} | {it} | {ks} | "
                   f"{_res_cell(res, bool(conv))} | {dt:.3f} | {icpo:.1f} |")
    return "\n".join(out)


def _gb(x):
    return "—" if x is None else f"{x:.2f}"


def _order(arg):
    return tuple((0, int(x), "") if x.isdigit() else (1, 0, x)
                 for x in arg.split(":"))


def section(cache, kind, formatter, label=False):
    """The table of ``kind``'s rows (those of ROWSPECS and any other in the
    cache; two columns more: setup + build seconds and peak GB; † on a
    stale row; with ``label`` a first column names each row's key), then
    every cut, failed and missing row with its reason († when stale)."""
    args = sorted({a for k, a in ROWSPECS if k == kind}
                  | {k.split(":", 1)[1] for k in cache
                     if k.split(":", 1)[0] == kind}, key=_order)
    rows, extra, notes, labels = [], [], [], []
    for arg in args:
        key = f"{kind}:{arg}"
        ent = cache.get(key)
        if ent is None:
            notes.append(f"`{key}`: not run")
        elif ent.get("row") is not None:
            rows.append(tuple(ent["row"]))
            labels.append(f"| `{key}` ")
            build = (ent.get("setup_seconds") or 0.0) + (
                ent.get("build_seconds") or 0.0)
            extra.append(f" {build:.1f} | {_gb(ent.get('peak_gb'))} |"
                         + (" †" if row_is_stale(kind, ent) else ""))
        else:
            notes.append(_failure(key, ent)
                         + (" †" if row_is_stale(kind, ent) else ""))
    lines = formatter(rows).splitlines()
    lines[0] += " setup + build [s] | peak GB |"
    lines[1] += "---|---|"
    for i, tail in enumerate(extra):
        lines[2 + i] += tail
    if label:
        lines = (["| row " + lines[0], "|---" + lines[1]]
                 + [lab + line for lab, line in zip(labels, lines[2:])])
    return "\n".join(lines + ([""] + [f"- {n}" for n in notes]
                              if notes else []))


def _failure(key, ent):
    cut = ent.get("cut")
    if ent.get("err") == "in progress":
        return (f"`{key}`: **cut**: its process ended during the row "
                f"(started {ent.get('measured')})")
    if cut is None:
        return f"`{key}`: failed: {short(ent.get('err') or 'no row')}"
    if cut["reason"] == "limit":
        head = (f"`{key}`: **cut** at its {cut['limit']:.0f} s limit "
                f"({cut['seconds']:.1f} s)")
    else:
        head = (f"`{key}`: **cut**, its process ended with code "
                f"{cut['rc']} after {cut['seconds']:.1f} s"
                + (f" ({cut['error']})" if cut.get("error") else ""))
    return head + (f"; last line: `{cut['last_line']}`"
                   if cut.get("last_line") else "")


def gamma_section(cache, key):
    ent = cache.get(key)
    if ent is None or ent.get("row") is None:
        return "- " + (_failure(key, ent) if ent else f"`{key}`: not run")
    n, m, best, gammas, iters, dt = ent["row"]
    out = [f"{n:,} + {m:,} dofs (cycle 0), {len(gammas)} values of γ = "
           f"γ_background = γ_immersed from {gammas[0]:g} to {gammas[-1]:g}; "
           f"best γ = {best:g}; the study took {dt:.2f} s"
           + (" †" if row_is_stale("gamma_study", ent) else "") + ".", "",
           "| γ from | γ to | values | outer iterations |",
           "|---|---|---|---|"]
    start = 0
    for i in range(1, len(gammas) + 1):
        if i == len(gammas) or iters[i] != iters[start]:
            out.append(f"| {gammas[start]:.4g} | {gammas[i - 1]:.4g} | "
                       f"{i - start} | {iters[start]} |")
            start = i
    return "\n".join(out)


# the columns of the convergence study's table, in the order of
# EllipticInterfaceProblem.run()'s rows
STUDY_COLUMNS = ("cells", "dof_background", "dof_immersed", "gamma",
                 "outer_iterations", "L2", "L2.rate", "H1", "H1.rate",
                 "constraint_residual")


def _study_cell(col, v):
    if isinstance(v, int):
        return f"{v:,}"
    if not isinstance(v, float):
        return "" if v is None else str(v)
    if col.endswith(".rate"):
        return f"{v:.2f}"
    return f"{v:g}" if col == "gamma" else f"{v:.3e}"


def convergence_section(cache, key):
    ent = cache.get(key)
    if ent is None or ent.get("row") is None:
        return "- " + (_failure(key, ent) if ent else f"`{key}`: not run")
    rows, dt = ent["row"]
    cols = [c for c in STUDY_COLUMNS if c in rows[0]] + sorted(
        c for c in rows[0] if c not in STUDY_COLUMNS)
    out = ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
    for r in rows:
        out.append("| " + " | ".join(_study_cell(c, r.get(c))
                                     for c in cols) + " |")
    return "\n".join(out) + (f"\n\nThe study took {dt:.2f} s"
                             + (" †" if row_is_stale("convergence_study",
                                                     ent) else "") + ".")


def _keys(cache, kind):
    """The cached keys of ``kind``, or its ROWSPECS key when none is."""
    keys = sorted(k for k in cache if k.split(":", 1)[0] == kind)
    return keys or [f"{k}:{a}" for k, a in ROWSPECS if k == kind]


def render(cache):
    """The whole table from the cache's entries."""
    measured = [e for e in cache.values() if e.get("card")]
    cards = sorted({e["card"] for e in measured})
    versions = sorted({f"torch {e['torch']}, CUDA {e['cuda']}"
                       for e in measured})
    stale = sorted(k for k, e in cache.items()
                   if k.split(":", 1)[0] in FAMILY_MODEL
                   and row_is_stale(k.split(":", 1)[0], e))
    dates = sorted(e["measured"] for e in measured if e.get("measured"))
    parts = [
        "# H100 results — h-independence of AL-preconditioned outer iterations (PyTorch port)",
        "",
        "Generated by `scripts/make_results_table_torch.py` from "
        "`tables/.results_h100_rows.json`.",
        "",
        f"Card (`nvidia-smi` name, power limit): {'; '.join(cards) or 'none'}.",
        f"Software: {'; '.join(versions) or 'none'}.",
        (f"Rows measured {dates[0]} to {dates[-1]}." if dates else ""),
        "",
        "Precision: the Krylov solvers and the operators run in float64, the "
        "V-cycles in float32 (K1, K2 and K6 in float32; K6 also in float64 "
        "in the elliptic operator and inner CGs).  The TPU table "
        "(`tables/results_tpu.md`) ran everything in float32, so the two "
        "tables' counts need not match row for row (PERF.md §6: the "
        "rational rows).  Each row is one warm solve, then one timed solve "
        "that ends in `torch.cuda.synchronize()`; 'setup + build' is the "
        "problem's `setup()` and the first solve's solver build; 'peak GB' "
        "is `torch.cuda.max_memory_allocated` over the row.  Rows run one "
        "subprocess each under a time limit, or a family in one process "
        "(`scripts/measure_family_torch.py`); a cut or failed row is listed "
        "under its table with its reason.",
        "",
        "## immersed_laplace, `augmented` (operator form, diag W), circle, smooth data",
        "",
        "Outer reduction 1e-6, tolerance 3e-5; from refinement 13 the FGMRES "
        "basis holds 12 vectors.",
        "",
        section(cache, "laplace", fmt),
        "",
        "## reference solve quality: 1e-10 absolute via iterative refinement",
        "",
        "Float32 V-cycles under the correction solves on the card; the true "
        "float64 residual of the augmented system on the host each step "
        "(`ops/host_ref.py`).",
        "",
        section(cache, "refined", fmt_refined),
        "",
        "## immersed_laplace, `rational` (AAA fractional preconditioner), f=0 g=1 circle",
        "",
        section(cache, "rational", fmt),
        "",
        "## elliptic_interface, modified AL, beta jump 1e3 — refinement to 1e-10",
        "",
        "'total outer its' sums the outer FGMRES iterations across the "
        "refinement steps.",
        "",
        section(cache, "elliptic", fmt_refined),
        "",
        "## stokes_immersed_boundary 2D, IBStokesAL (grad-div, diag mass) — refinement to 1e-8",
        "",
        section(cache, "stokes", fmt_refined),
        "",
        "## stokes_immersed_boundary 3D (<2,3> instantiation), IBStokesAL — refinement to 1e-8",
        "",
        "Sphere of radius 0.1 at the cube's center, g = (-1,1,0), body force "
        "(1,0,0).",
        "",
        section(cache, "stokes3d", fmt_refined),
        "",
        "## nitsche_bcs (boundary-multiplier Dirichlet), manufactured solution — refinement to 1e-10",
        "",
        "Last column of the JAX table's: inner CG iterations per outer "
        "iteration.",
        "",
        section(cache, "nitsche", fmt_nitsche),
        "",
        "## elliptic_interface_elasticity 3D (modified AL) — refinement to 1e-10",
        "",
        "Cycle 3 (1,039,497 dofs) is a row the TPU table does not have.",
        "",
        section(cache, "elasticity", fmt_refined),
        "",
        "## Locally refined near Γ (one step), element-form path",
        "",
        "The shipped parameter files at (embedding, embedded) refinements, "
        "read by `ImmersedLaplaceConfig.from_prm`, under the laplace rows' "
        "rule; the flower also at (11, 12).",
        "",
        section(cache, "adaptive", fmt, label=True),
        "",
        "Stokes with one local step (`delta_refinement = 1`): 2D at 9 + 1:10, "
        "3D at 6 + 1 around a sphere of refinement 4; refinement to 1e-8.",
        "",
        section(cache, "adaptive_stokes", fmt_refined, label=True),
        "",
        section(cache, "adaptive_stokes3d", fmt_refined, label=True),
        "",
        "## Elliptic interface studies (parameters/elliptic_interface_modified.prm)",
        "",
        "The γ study (`EllipticInterfaceProblem.parameter_study`): outer "
        "iterations at cycle 0 for each γ, grouped where the count is the "
        "same.",
        "",
        "\n\n".join(gamma_section(cache, k)
                   for k in _keys(cache, "gamma_study")),
        "",
        "The convergence study (`run()` with `do_convergence_study`: the "
        "ball in [-1.4, 1.4]², β = 1, 10, the exact solution's L2 and H1 "
        "errors and their rates).",
        "",
        "\n\n".join(convergence_section(cache, k)
                     for k in _keys(cache, "convergence_study")),
        "",
    ]
    parts.append("Rows marked † are stale: a file that produces them "
                 f"changed after they were measured ({', '.join(stale)})."
                 if stale else "Every row is fresh: no file that produces "
                 "it changed after it was measured.")
    parts.append("")
    return "\n".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--row", help="compute one row (kind:arg) in this "
                                  "process and print it as 'ROW <json>'")
    ap.add_argument("--rows", help="compute these rows (comma-separated "
                                   "kind:arg), not every row of ROWSPECS")
    ap.add_argument("--render", action="store_true",
                    help="write the table from the cache, computing nothing")
    ap.add_argument("--merge", action="append", default=[],
                    help="a cache file whose entries are merged in first")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cache", default=CACHE)
    ap.add_argument("--out", default=TABLE)
    ap.add_argument("--row-timeout", type=float, default=ROW_TIMEOUT_S)
    args = ap.parse_args(argv)
    if args.row:
        kind, arg = args.row.split(":", 1)
        print("ROW " + json.dumps(compute_row(kind, arg, args.device)),
              flush=True)
        return 0
    for path in args.merge:
        save_entries(args.cache, load_cache(path))
    if not args.render:
        keys = (args.rows.split(",") if args.rows else
                [f"{k}:{a}" for k, a in ROWSPECS])
        orchestrate(args.device, args.cache, keys, args.row_timeout)
    with open(args.out, "w") as fh:
        fh.write(render(load_cache(args.cache)))
    print(f"wrote {os.path.relpath(args.out, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
