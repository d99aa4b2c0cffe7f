"""Phase timers — deal.II ``TimerOutput`` analog (reference N16).

Counterpart of ``fictitious_domain_al_preconditioners_tpu.utils.timer``.
Sections wait for the CUDA card (when one is in use) before they stop the
clock, so wall times are honest under asynchronous launches.  ``summary()``
prints the familiar wall-time table.  While the port's tracer is on
(:mod:`..tracer`), each section is also recorded as a span of its name:
the set-up phases are roots of the span tree, a solve's phases sit under
its ``solve`` span.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from ..tracer import span

__all__ = ["TimerOutput"]


class TimerOutput:
    def __init__(self):
        self.wall = defaultdict(float)
        self.calls = defaultdict(int)

    @contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        with span(name):
            try:
                yield
            finally:
                # drain queued kernels so the section is charged its real
                # cost
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                self.wall[name] += time.perf_counter() - t0
                self.calls[name] += 1

    def summary(self) -> str:
        total = sum(self.wall.values())
        lines = ["+---------------------------------+------------+------------+",
                 "| Section                         |   n calls  |  wall time |",
                 "+---------------------------------+------------+------------+"]
        for name in sorted(self.wall, key=lambda k: -self.wall[k]):
            lines.append(f"| {name:<31} | {self.calls[name]:>10} | "
                         f"{self.wall[name]:>9.3f}s |")
        lines.append("+---------------------------------+------------+------------+")
        lines.append(f"| Total                           |            | {total:>9.3f}s |")
        lines.append("+---------------------------------+------------+------------+")
        return "\n".join(lines)
