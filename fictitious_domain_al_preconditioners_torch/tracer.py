"""Spans inside the port: where a solve spends its host time, down to each
V-cycle level.

    from fictitious_domain_al_preconditioners_torch import tracer
    tracer.enable()
    prob.solve()
    print(tracer.report(tracer.disable()))

While the tracer is on, ``span(name, **attrs)`` records the interval of
its ``with`` block in memory, with the enclosing span and the solve it
belongs to.  It never waits for the device and never opens a profiler
range: a span's time is the host's, which on a CUDA card is the time to
enqueue the work, plus the waits of the syncs inside it.  Stamps are
``time.time_ns()``, the wall clock that ``torch.profiler`` stamps its
events with, so spans can be laid over a profiler trace.  While it is off,
``span`` returns one shared no-op context: the cost of a span site is a
call and a global read.

The spans, each where its work happens: ``solve`` (each model's
``solve()``, opened by ``models.session.SolveSession.solve``; attributes
``family``, ``solver``), the phase scopes of
``utils.timer.TimerOutput`` (named as in its table), ``krylov.outer_step``
(one FGMRES/GMRES or MINRES step), ``krylov.sync`` (one device-to-host read
of a Krylov solver), ``al.apply`` (one application of an AL preconditioner;
``form``), ``al.block_solve`` (its inner CG on the V-cycle),
``gmg.vcycle`` (``levels``), ``gmg.level`` (one level visit, the coarse
solve the last; ``level``, ``shape``), ``gmg.graph`` (one replay of the
CUDA graph of the cycle below level 0; ``levels``) and ``coupling.mv`` /
``coupling.rmv`` (C and Cᵀ).

The tracer lives in this module, not in ``utils.timer``, whose package
imports ``ops.coupling``: a span there would close an import cycle.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

__all__ = ["Span", "span", "enable", "disable", "report"]


class Span(NamedTuple):
    name: str
    start_ns: int        # time.time_ns() at entry
    end_ns: int          # and at exit
    parent: int          # index of the enclosing span, -1 for a root
    solve: int           # 0, 1, … for the solves in order; -1 outside any
    attrs: dict


class _Tracer:
    """The spans recorded since :func:`enable`: ``records`` holds one list
    ``[name, start, end, parent, solve, attrs]`` a span, in entry order."""

    def __init__(self):
        self.records = []
        self.open = []           # indices of the open spans, innermost last
        self.solves = 0


class _Scope:
    __slots__ = ("tracer", "name", "attrs")

    def __init__(self, tracer, name, attrs):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        tr = self.tracer
        parent = tr.open[-1] if tr.open else -1
        if self.name == "solve":
            solve = tr.solves
            tr.solves += 1
        else:
            solve = tr.records[parent][4] if parent >= 0 else -1
        tr.open.append(len(tr.records))
        tr.records.append([self.name, time.time_ns(), 0, parent, solve,
                           self.attrs])

    def __exit__(self, *exc):
        tr = self.tracer
        tr.records[tr.open.pop()][2] = time.time_ns()
        return False


_OFF = contextlib.nullcontext()
#: the tracer that is on, one a process (like the profiler), or None
_active: _Tracer | None = None


def span(name: str, **attrs):
    """A context recording ``name`` while the tracer is on, else a no-op."""
    if _active is None:
        return _OFF
    return _Scope(_active, name, attrs)


def enable():
    """Start recording spans (a fresh list)."""
    global _active
    if _active is not None:
        raise RuntimeError("the tracer is already on")
    _active = _Tracer()


def disable() -> list:
    """Stop recording; the spans recorded, in entry order (``[]`` if the
    tracer was off).  A span still open has ``end_ns`` 0."""
    global _active
    tr, _active = _active, None
    return [] if tr is None else [Span(*r) for r in tr.records]


def report(spans: list) -> str:
    """One line a span path (``solve/Solve system/krylov.outer_step/…``):
    calls, total ms and self ms (total less the time its child spans
    cover), in the order the paths were first entered."""
    paths, child_ns = [], [0] * len(spans)
    rows = defaultdict(lambda: [0, 0, 0])
    for i, s in enumerate(spans):
        paths.append(s.name if s.parent < 0
                     else f"{paths[s.parent]}/{s.name}")
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    for i, s in enumerate(spans):
        row = rows[paths[i]]
        row[0] += 1
        row[1] += s.end_ns - s.start_ns
        row[2] += s.end_ns - s.start_ns - child_ns[i]
    width = max((len(p) for p in rows), default=4)
    lines = [f"{'span':<{width}}  {'calls':>7}  {'total ms':>10}  "
             f"{'self ms':>10}"]
    for p, (n, tot, own) in rows.items():
        lines.append(f"{p:<{width}}  {n:>7}  {tot / 1e6:>10.3f}  "
                     f"{own / 1e6:>10.3f}")
    return "\n".join(lines)
