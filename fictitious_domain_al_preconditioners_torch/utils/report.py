"""Results reporting: CSV appenders and convergence tables.

Replaces the reference's ``ResultsData`` + ``export_results_to_csv_file``
(immersed_laplace.cc:62-66, 1013-1030) and deal.II ``ConvergenceTable``
(elliptic_interface.cc:1053-1060).  Copy of
``fictitious_domain_al_preconditioners_tpu.utils.report`` (standard library
only)."""

from __future__ import annotations

import math
import os

__all__ = ["append_results_csv", "ConvergenceTable"]


def append_results_csv(path: str, row: dict):
    """Append one row (creating a header if the file is new) — the
    ``<prm-stem>.csv`` artifact: dofs_background, dofs_immersed, outer_iters."""
    new = not os.path.exists(path)
    with open(path, "a") as fh:
        if new:
            fh.write(",".join(row.keys()) + "\n")
        fh.write(",".join(str(v) for v in row.values()) + "\n")


class ConvergenceTable:
    """Accumulates per-cycle rows; computes log2 reduction rates for selected
    columns; renders an org-mode style text table."""

    def __init__(self):
        self.rows = []

    def add_row(self, **kv):
        self.rows.append(dict(kv))

    def evaluate_rates(self, columns):
        for col in columns:
            prev = None
            for row in self.rows:
                v = row.get(col)
                rate = ""
                if prev not in (None, 0) and v not in (None, 0):
                    rate = f"{math.log2(prev / v):.2f}"
                row[col + ".rate"] = rate
                prev = v

    def render(self) -> str:
        if not self.rows:
            return ""
        cols = list(self.rows[0].keys())
        for r in self.rows:
            for c in r:
                if c not in cols:
                    cols.append(c)

        def fmt(v):
            if isinstance(v, float):
                return f"{v:.4e}"
            return str(v)

        widths = {c: max(len(c), *(len(fmt(r.get(c, ""))) for r in self.rows))
                  for c in cols}
        header = "| " + " | ".join(c.ljust(widths[c]) for c in cols) + " |"
        sep = "|-" + "-|-".join("-" * widths[c] for c in cols) + "-|"
        body = ["| " + " | ".join(fmt(r.get(c, "")).ljust(widths[c])
                                  for c in cols) + " |" for r in self.rows]
        return "\n".join([header, sep] + body)
