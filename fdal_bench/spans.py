"""The port's own spans (the program's ``tracer`` module) laid over the
profiler's events of a traced run, and the traced run that records both:

    python3 -m fdal_bench.spans --workload <cell> --seed <n> \
        --seconds <s> [--on-cost-pairs <k>] [--out <file>]

The tracer stamps its spans on the wall clock, the clock of the profiler's
raw events, so a span converts to the trace's axis (µs from
``trace_start_ns()``) by one subtraction.  :func:`join` charges

- each idle interval of the traced window (the complement of the union of
  device events, the benchmark's own ranges' device annotations left out,
  as ``trace.reduce`` takes it), piece by piece, to the innermost program
  span open at each instant;
- each device operation to the span open at the host time of its launching
  runtime call (``cuda*``, found by correlation id), or of the host op it
  is linked to;

and sums, over the solves that ran after the profiled ones (whose host
times the profiler does not slow), the time of named spans.  The five
readers ``metrics/inner_iterations.py``, ``sync_wait_ms_per_solve.py``,
``vcycle_ms_per_solve.py``, ``vcycle_device_idle_pct.py`` and
``coupling_device_ms_per_solve.py`` read a run's ``spans`` attribute (a
:class:`SpanData`) and the requests' ``inner_iterations``.  ``run.py`` sets
neither yet; the command above makes a traced run of ``run.run_cell`` that
does (the tracer on from set-up to the end of the window), prints the
readings, the idle by span path, the per-level table, the share of idle
time no layer span names, the clock check and the profiler's slowdown, and
with ``--on-cost-pairs`` times solves of one request with the tracer on and
off in turns in one process."""

from __future__ import annotations

import argparse
import bisect
import collections
import gc
import json
import os
import statistics
import sys
import time
from dataclasses import asdict, dataclass, field

from .trace import PREFIX, WINDOW, _union

#: the spans of the solver's layers; idle time whose innermost span is
#: another (``solve``, a phase scope) or none is not named by a layer
LAYERS = ("krylov.", "al.", "gmg.", "coupling.")


@dataclass
class SpanData:
    """The join of one traced run (seconds unless named otherwise)."""

    profiled_solves: int            # program solves inside the traced window
    after_solves: int               # solves of the window after them
    spans_per_solve: float          # over the after solves
    sync_s_after: float             # summed krylov.sync, after solves
    vcycle_s_after: float           # summed gmg.vcycle, after solves
    vcycle_s_profiled: float        # summed gmg.vcycle, profiled solves
    vcycle_idle_s: float            # device idle inside those
    coupling_device_s: float        # device time launched in coupling.*
    solve_idle_s: float             # idle inside fdal_bench.solve ranges
    solve_idle_unnamed_s: float     # of it, outside every layer span
    syncs_profiled: int
    syncs_with_copy: int            # holding a cudaMemcpyAsync call
    solve_s_profiled: float         # mean solve span, profiled solves
    solve_s_after: float            # and after
    idle_by_span: list = field(default_factory=list)   # [[path, s]]
    levels: list = field(default_factory=list)   # one dict a V-cycle level
    slowdown: dict = field(default_factory=dict)  # span: profiled / after


def _intersect(a, b):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _innermost(iv):
    """Pieces ``(start, end, i)`` of the time the nested intervals ``iv``
    (in entry order) cover, ``i`` the innermost one open; ``-1`` in the
    gaps between them."""
    ev = sorted([(s, 1, k) for k, (s, _) in enumerate(iv)]
                + [(e, 0, -k) for k, (_, e) in enumerate(iv)])
    out, stack, prev = [], [], None
    for t, kind, k in ev:
        if prev is not None and t > prev:
            out.append((prev, t, stack[-1] if stack else -1))
        prev = t
        if kind:
            stack.append(k)
        else:
            stack.remove(-k)
    return out


def _charge(intervals, pieces):
    """µs of ``intervals`` (sorted, disjoint) in each piece's owner."""
    acc = collections.Counter()
    j = 0
    for s, e in intervals:
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, owner = pieces[k]
            acc[owner] += min(b, e) - max(a, s)
            k += 1
    return acc


def join(spans, device, host, t0_ns: int, top: int = 10) -> SpanData:
    """Join the program's spans (``tracer.Span``, ns on the wall clock) with
    a traced window's events (``trace.events_of``: µs from ``t0_ns``)."""
    win = [e for e in host if e.name == WINDOW]
    if not win:
        raise ValueError("spans: no traced window range")
    w0, w1 = win[0].start, win[0].end
    iv = [((s.start_ns - t0_ns) / 1e3, (s.end_ns - t0_ns) / 1e3)
          for s in spans]
    paths, under = [], []        # under: names of the span and its ancestors
    for s in spans:
        up = under[s.parent] if s.parent >= 0 else frozenset()
        under.append(up | {s.name})
        name = s.name
        if name == "gmg.level":
            # a level visit runs inside the finer level's: path it by level
            name = f"gmg.level[{s.attrs.get('level')}]"
            if spans[s.parent].name == "gmg.level":
                paths.append(f"{paths[s.parent].rsplit('/', 1)[0]}/{name}")
                continue
        paths.append(name if s.parent < 0 else f"{paths[s.parent]}/{name}")

    solves = [(i, s) for i, s in enumerate(spans) if s.name == "solve"]
    prof = {s.solve for i, s in solves if iv[i][0] >= w0 and iv[i][1] <= w1}
    after = {s.solve for i, s in solves if iv[i][0] > w1}
    n_prof, n_after = len(prof), len(after)

    # the device's idle intervals in the window, as trace.reduce takes them
    range_names = {e.name for e in host if e.name.startswith(PREFIX)}
    dev = [e for e in device if e.name not in range_names
           and e.end > w0 and e.start < w1]
    busy = _union([(max(e.start, w0), min(e.end, w1)) for e in dev])
    idle, prev = [], w0
    for s, e in busy:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        idle.append((prev, w1))

    inside = [k for k, (s, e) in enumerate(iv) if e > w0 and s < w1]
    pieces = [(a, b, inside[k]) if k >= 0 else (a, b, -1)
              for a, b, k in _innermost([iv[k] for k in inside])]
    idle_at = _charge(idle, pieces)
    # idle time outside every span, those before the first and after the
    # last included
    idle_at[-1] += sum(e - s for s, e in idle) - sum(idle_at.values())
    by_path = collections.Counter()
    for owner, us in idle_at.items():
        by_path[paths[owner] if owner >= 0 else "(no span)"] += us / 1e6

    def named(owner):
        return owner >= 0 and spans[owner].name.startswith(LAYERS)

    bench_solves = _union([(e.start, e.end) for e in host
                           if e.name == PREFIX + "solve"
                           and e.start >= w0 and e.end <= w1])
    idle_in_solves = _intersect(idle, bench_solves)
    solve_idle_us = sum(e - s for s, e in idle_in_solves)
    named_us = sum(us for k, us in _charge(idle_in_solves, pieces).items()
                   if named(k))

    # device operations by the span open at their launch
    runtime_at = {e.corr: e.start for e in host
                  if e.corr and e.name.startswith("cu")}
    op_at = {e.corr: e.start for e in host
             if e.corr and not e.name.startswith("cu")}
    starts = [p[0] for p in pieces]
    dev_at = collections.Counter()
    for e in dev:
        t = runtime_at.get(e.corr, op_at.get(e.linked))
        if t is None:
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and pieces[j][1] >= t:
            dev_at[pieces[j][2]] += e.end - e.start

    copies = sorted(e.start for e in host if e.name == "cudaMemcpyAsync")
    syncs = [iv[k] for k in inside if spans[k].name == "krylov.sync"
             and spans[k].solve in prof]
    with_copy = sum(1 for s, e in syncs
                    if bisect.bisect_left(copies, s) < len(copies)
                    and copies[bisect.bisect_left(copies, s)] <= e)

    dur = [(e - s) / 1e6 for s, e in iv]
    child = [0.0] * len(spans)
    for k, s in enumerate(spans):
        if s.parent >= 0:
            child[s.parent] += dur[k]

    def total(name, which):
        return sum(dur[k] for k, s in enumerate(spans)
                   if s.name == name and s.solve in which)

    levels, both = {}, prof | after
    for k, s in enumerate(spans):
        if s.name != "gmg.level" or s.solve not in both:
            continue
        row = levels.setdefault(s.attrs.get("level"), dict(
            level=s.attrs.get("level"), shape=list(s.attrs.get("shape", ())),
            visits=0, host_self_ms=0.0, device_ms=0.0, idle_ms=0.0))
        if s.solve in after:
            row["visits"] += 1
            row["host_self_ms"] += 1e3 * (dur[k] - child[k])
        else:
            row["device_ms"] += dev_at.get(k, 0.0) / 1e3
            row["idle_ms"] += idle_at.get(k, 0.0) / 1e3
    for row in levels.values():
        for key, n in (("visits", n_after), ("host_self_ms", n_after),
                       ("device_ms", n_prof), ("idle_ms", n_prof)):
            row[key] = row[key] / n if n else None

    slowdown = {}
    for name in ("solve", "krylov.sync", "al.block_solve", "gmg.vcycle",
                 "coupling.mv", "coupling.rmv"):
        a, b = total(name, prof), total(name, after)
        if n_prof and n_after and b > 0:
            slowdown[name] = (a / n_prof) / (b / n_after)

    return SpanData(
        profiled_solves=n_prof, after_solves=n_after,
        spans_per_solve=(sum(1 for s in spans if s.solve in after) / n_after
                         if n_after else 0.0),
        sync_s_after=total("krylov.sync", after),
        vcycle_s_after=total("gmg.vcycle", after),
        vcycle_s_profiled=total("gmg.vcycle", prof),
        vcycle_idle_s=sum(us for k, us in idle_at.items()
                          if k >= 0 and "gmg.vcycle" in under[k]) / 1e6,
        coupling_device_s=sum(
            us for k, us in dev_at.items()
            if k >= 0 and any(n.startswith("coupling.") for n in under[k]))
        / 1e6,
        solve_idle_s=solve_idle_us / 1e6,
        solve_idle_unnamed_s=(solve_idle_us - named_us) / 1e6,
        syncs_profiled=len(syncs), syncs_with_copy=with_copy,
        solve_s_profiled=total("solve", prof) / n_prof if n_prof else 0.0,
        solve_s_after=total("solve", after) / n_after if n_after else 0.0,
        idle_by_span=[[p[:160], s] for p, s in by_path.most_common(top)],
        levels=[levels[k] for k in sorted(levels)],
        slowdown=slowdown)


# -- the traced run with spans ----------------------------------------------

NEW_METRICS = ("inner_iterations", "sync_wait_ms_per_solve",
               "vcycle_ms_per_solve", "vcycle_device_idle_pct",
               "coupling_device_ms_per_solve")


class _Recording:
    """While entered: the program's tracer on, ``run.events_of`` keeping
    the profiler's clock origin and events, and the family's requests
    recording ``results["inner_iterations"]``."""

    def __init__(self, fam):
        self.fam = fam
        self.spans = self.events = self.t0_ns = None

    def __enter__(self):
        from fictitious_domain_al_preconditioners_torch import tracer

        from . import run

        self.tracer, self.run = tracer, run
        self.events_of, self.solve = run.events_of, self.fam.Driver.solve

        def events_of(prof):
            self.t0_ns = prof.profiler.kineto_results.trace_start_ns()
            self.events = self.events_of(prof)
            return self.events

        def solve(drv):
            answer, rec = self.solve(drv)
            rec["inner_iterations"] = drv.prob.results.get("inner_iterations")
            return answer, rec

        run.events_of, self.fam.Driver.solve = events_of, solve
        tracer.enable()
        return self

    def __exit__(self, *exc):
        self.spans = self.tracer.disable()
        self.run.events_of, self.fam.Driver.solve = self.events_of, self.solve
        return False


def traced_run(cell, seed: int, seconds: float, device="cuda:0"):
    """``run.run_cell`` with ``--trace 1`` and the program's spans: ``(Run,
    checks, stages)``, the Run's ``spans`` the :class:`SpanData`."""
    from . import run

    with _Recording(cell.family()) as rec:
        r, checks, stages = run.run_cell(cell, seed, seconds, True,
                                         device=device)
    r.spans = join(rec.spans, *rec.events, rec.t0_ns)
    return r, checks, stages


def on_cost(cell, seed: int, pairs: int, device="cuda:0"):
    """Seconds of one solve with the tracer off and on, in pairs that solve
    the same request, the order alternating (off first in even pairs), in
    one process on one set-up: ``[[off_s, on_s, spans], …]`` a pair."""
    import torch

    from fictitious_domain_al_preconditioners_torch import tracer

    from .traffic import Requests

    drv = cell.family().Driver(cell.config, device)
    drv.setup()
    drv.prepare(cell.traffic["modes"])
    requests = Requests(cell.traffic, seed)
    drv.set_data([1.0] + [0.0] * (len(cell.traffic["modes"]) - 1))
    drv.solve()
    out = []
    for p in range(pairs):
        drv.set_data(requests.weights(p))
        got = {}
        for on in ((False, True) if p % 2 == 0 else (True, False)):
            if on:
                tracer.enable()
            t0 = time.perf_counter()
            drv.solve()
            torch.cuda.synchronize()
            got[on] = time.perf_counter() - t0
            if on:
                n_spans = len(tracer.disable())
        out.append([got[False], got[True], n_spans])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--on-cost-pairs", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    from . import run, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("fdal_bench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    seed = args.seed & (2 ** 64 - 1)
    r, checks, _ = traced_run(cell, seed, args.seconds)
    device_info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                       count=1, memory_peak_bytes=r.peak_bytes,
                       power_limit_w=run.power_limit_w())
    out = run.result_line(cell, r, checks, True, device_info)
    for name in NEW_METRICS:
        value = cell.reader(name)(r)
        out["metrics"][name] = None if value is None else dict(value=value)
    out["spans"] = asdict(r.spans)
    if args.on_cost_pairs:
        gc.collect()
        torch.cuda.empty_cache()
        out["on_cost"] = on_cost(cell, seed, args.on_cost_pairs)
        ratios = [on / off for off, on, _ in out["on_cost"]]
        out["on_cost_median_ratio"] = statistics.median(ratios)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text, flush=True)
    return 0 if run.passed(checks) else 1


if __name__ == "__main__":
    sys.exit(main())
