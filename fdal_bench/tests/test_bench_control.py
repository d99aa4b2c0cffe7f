"""The comparison that decides ``correct`` fails what it must: the control
(the precision below the configuration's) and each fault a solve can have,
with the rest of a run driven as on the card, at a size the CPU holds."""

import pytest
import torch

from fdal_bench import control, run, spec
from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceProblem, StokesProblem)

CELLS = ["laplace_circle.r12_f32", "stokes2d_circle.r9_10"]


def _fails(row, limits):
    return any(row[name] > limit for name, limit in limits.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(bench_root, name):
    root, pkg = bench_root
    cell = spec.load_cell(name, root=root, package_dir=pkg)
    seeds = [2 ** 31 + k for k in range(3)]
    rows = control.readings(cell, seeds, set(seeds), "cpu")
    limits = cell.workload["limits"]
    prog = [r for r in rows if r["kind"] == "program"]
    ctl = [r for r in rows if r["kind"] == "control"]
    assert len(prog) == len(ctl) == 3
    assert all(r["ok"] and not _fails(r, limits) for r in prog), prog
    assert all(_fails(r, limits) for r in ctl), ctl


def _altered(solve):
    """The answer altered where it is produced: u off by 1% everywhere."""
    def wrapped(self, *a, **k):
        out = solve(self, *a, **k)
        return (out[0] * 1.01,) + tuple(out[1:])
    return wrapped


def _stale(solve):
    """Every solve after the first returns the first answer."""
    first = {}

    def wrapped(self, *a, **k):
        out = solve(self, *a, **k)
        first.setdefault(id(self), tuple(x.clone() if torch.is_tensor(x)
                                         else x for x in out))
        return first[id(self)]
    return wrapped


@pytest.mark.parametrize("fault", [_altered, _stale])
@pytest.mark.parametrize("name, cls", [("laplace_circle.r12_f32",
                                        ImmersedLaplaceProblem),
                                       ("stokes2d_circle.r9_10",
                                        StokesProblem)])
def test_a_fault_makes_the_run_incorrect(bench_root, monkeypatch, fault,
                                         name, cls):
    root, pkg = bench_root
    cell = spec.load_cell(name, root=root, package_dir=pkg)
    monkeypatch.setattr(cls, "solve", fault(cls.solve))
    r, checks, _ = run.run_cell(cell, 2 ** 32 + 3, 0.5, False, device="cpu")
    assert checks["answers"]["value"] >= 1
    assert not run.passed(checks), checks
