"""The port's span tracer (``tracer``) and the inner-iteration counter on
the CPU: spans only while the tracer is on, one ``solve`` root a solve with
its children nested inside it, counts of steps, syncs and level visits that
agree with the solve's own counters, and stamps on the profiler's clock."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fictitious_domain_al_preconditioners_torch import tracer
from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceProblem, StokesProblem)
from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
    import ImmersedLaplaceConfig
from fictitious_domain_al_preconditioners_torch.models.stokes import (
    ALControl, StokesConfig)
from fictitious_domain_al_preconditioners_torch.precond import al


def laplace():
    cfg = ImmersedLaplaceConfig(
        initial_refinement=5, initial_embedded_refinement=5,
        solver="augmented", use_operator_form=True, use_diagonal_inverse=True,
        embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                "R=.2, Cx=.4, Cy=.4"))
    return ImmersedLaplaceProblem(cfg, device="cpu",
                                  dtype=torch.float32).setup()


def stokes():
    cfg = StokesConfig(spacedim=2, initial_refinement=4,
                       initial_embedded_refinement=5,
                       al=ALControl(grad_div_stabilization=True,
                                    inverse_diag_square=True))
    cfg.outer.tolerance, cfg.outer.reduction = 3e-4, 1e-5
    return StokesProblem(cfg, device="cpu", dtype=torch.float32).setup()


@pytest.fixture(scope="module")
def problems():
    return {"laplace": laplace(), "stokes": stokes()}


def traced_solves(prob, n=2):
    prob.solve()                      # builds the solver outside the trace
    tracer.enable()
    results = []
    for _ in range(n):
        prob.solve()
        results.append(dict(prob.results))
    return tracer.disable(), results


@pytest.fixture(scope="module")
def traced(problems):
    """Two traced solves of each problem: ``(spans, results)``."""
    return {name: traced_solves(prob) for name, prob in problems.items()}


@pytest.fixture(autouse=True)
def tracer_off():
    yield
    tracer.disable()


def test_off_records_nothing(problems):
    problems["laplace"].solve()
    assert tracer.disable() == []
    assert tracer.span("solve") is tracer.span("gmg.level", level=3)


def test_enable_twice_raises():
    tracer.enable()
    with pytest.raises(RuntimeError):
        tracer.enable()


@pytest.mark.parametrize("name", ["laplace", "stokes"])
def test_one_solve_root_a_solve_children_nested(traced, name):
    spans, results = traced[name]
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == ["solve", "solve"]
    assert [s.solve for s in roots] == [0, 1]
    assert roots[0].attrs["family"] == {"laplace": "immersed_laplace",
                                        "stokes": "stokes"}[name]
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.solve == p.solve
    names = {s.name for s in spans}
    assert {"Solve system", "krylov.outer_step", "krylov.sync", "al.apply",
            "al.block_solve", "gmg.vcycle", "gmg.level", "coupling.mv",
            "coupling.rmv"} <= names
    # a solve's phase scope sits under its solve span
    phase = next(s for s in spans if s.name == "Solve system")
    assert spans[phase.parent].name == "solve"


@pytest.mark.parametrize("name", ["laplace", "stokes"])
def test_counts_agree_with_the_solve_counters(traced, name):
    spans, results = traced[name]
    for k, res in enumerate(results):
        mine = [s for s in spans if s.solve == k]

        def count(n):
            return sum(1 for s in mine if s.name == n)

        assert count("krylov.outer_step") == res["outer_iterations"]
        assert count("krylov.sync") == res["host_syncs"]
        assert count("al.apply") == res["outer_iterations"]
        vcycles = [s for s in mine if s.name == "gmg.vcycle"]
        levels = vcycles[0].attrs["levels"]
        assert all(v.attrs["levels"] == levels for v in vcycles)
        assert count("gmg.level") == len(vcycles) * levels
        # the last level visit of a V-cycle is the coarse solve
        deepest = {s.attrs["level"] for s in mine if s.name == "gmg.level"}
        assert deepest == set(range(levels))
        assert res["inner_iterations"] > 0


def test_inner_iterations_are_the_block_solves_cg_iterations(problems,
                                                              monkeypatch):
    prob = problems["laplace"]
    prob.solve()
    seen = []
    cg = al.cg

    def counting_cg(*args, **kw):
        x, info = cg(*args, **kw)
        seen.append(info.iterations)
        return x, info

    monkeypatch.setattr(al, "cg", counting_cg)
    prob.solve()
    assert len(seen) == prob.results["outer_iterations"]
    assert prob.results["inner_iterations"] == sum(seen)
    # FGMRES reads once a solve and once a step, each inner CG once and once
    # an iteration
    assert prob.results["host_syncs"] == (
        1 + 2 * prob.results["outer_iterations"] + sum(seen))


def test_report_lists_paths_with_self_time(traced):
    spans, results = traced["laplace"]
    text = tracer.report(spans)
    assert text.splitlines()[1].split()[0] == "solve"
    line = next(ln for ln in text.splitlines()
                if ln.startswith("solve/Solve system/krylov.outer_step "))
    calls, total, own = line.split()[-3:]
    assert int(calls) == sum(r["outer_iterations"] for r in results)
    assert 0 <= float(own) <= float(total)


def test_stamps_bracket_the_profilers_op():
    """A span stamped on ``time.time_ns()`` holds the ATen op run inside it,
    as ``torch.profiler`` records it, to within 50 µs."""
    x = torch.ones(1 << 16)
    x.add(1.0)                        # warm the op outside the trace
    tracer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with tracer.span("probe"):
                x.add(1.0)
    spans = tracer.disable()
    ops = sorted((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::add")
    assert len(ops) == len(spans) == 5
    for s, (a, b) in zip(spans, ops):
        assert s.start_ns - 50_000 <= a <= b <= s.end_ns + 50_000
