"""What one run records, and the arithmetic of its end-to-end numbers."""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class Run:
    """One run of a cell: set-up, the window's requests, the device's peak
    memory and, in a traced run, the reduced trace (``trace.TraceData``)."""

    setup_s: float = 0.0              # process start to the warm solve's end
    compile_s: float = 0.0            # of setup_s, building the libraries
    problem_setup_s: float = 0.0      # the port's results["setup_seconds"]
    solver_build_s: float = 0.0       # results["build_seconds"]
    window_s: float = 0.0             # first request's start to last's end
    requests: list = field(default_factory=list)   # one dict a request
    peak_bytes: int = 0
    trace: object = None

    @property
    def attempted(self) -> int:
        return len(self.requests)

    @property
    def completed(self) -> list:
        return [r for r in self.requests if r["ok"]]

    @property
    def failed(self) -> int:
        return self.attempted - len(self.completed)

    def solve_s(self):
        """Window seconds over converged solves completed."""
        done = len(self.completed)
        return self.window_s / done if done else None

    def solve_p95_s(self, min_beyond: int = 10):
        """95th percentile (nearest rank) of every request's wall seconds,
        a failed one counting as the slowest, or None with fewer than
        ``min_beyond`` requests beyond it."""
        times = sorted(r["seconds"] if r["ok"] else float("inf")
                       for r in self.requests)
        if len(times) * 0.05 < min_beyond:
            return None
        value = times[math.ceil(0.95 * len(times)) - 1]   # nearest rank
        return value if math.isfinite(value) else None

    def mean(self, key: str):
        vals = [r[key] for r in self.requests if r.get(key) is not None]
        return sum(vals) / len(vals) if vals else None
