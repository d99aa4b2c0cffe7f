"""The join of the program's spans with the profiler's events on a synthetic
table, the five readers of it, and the traced run with spans on the CPU."""

import json
import os

import pytest

from fdal_bench import spans as sp
from fdal_bench import spec
from fdal_bench.trace import PREFIX, WINDOW, Event
from fdal_bench.window import Run
from fictitious_domain_al_preconditioners_torch.tracer import Span

T0 = 1_700_000_000_000_000_000          # the trace's origin, ns


def S(name, a, b, parent, solve, **attrs):
    """A program span from a to b µs after the trace's origin."""
    return Span(name, T0 + int(a * 1e3), T0 + int(b * 1e3), parent, solve,
                attrs)


def table():
    """A 100 µs window holding one profiled solve: a V-cycle of two levels,
    a Cᵀ apply and a sync; after the window one more solve.  On the device
    a kernel launched in each level (the second found by its linked host
    op alone), one in Cᵀ, the sync's copy and the solve's annotation."""
    spans = [
        S("solve", 6, 94, -1, 0, family="immersed_laplace"),     # 0
        S("krylov.outer_step", 8, 92, 0, 0, step=0),             # 1
        S("al.apply", 10, 50, 1, 0, form="dlm"),                 # 2
        S("al.block_solve", 11, 48, 2, 0),                       # 3
        S("gmg.vcycle", 11.5, 47, 3, 0, levels=2),               # 4
        S("gmg.level", 12, 46, 4, 0, level=0, shape=(9, 9)),     # 5
        S("gmg.level", 40, 45, 5, 0, level=1, shape=(5, 5)),     # 6
        S("coupling.rmv", 55, 58, 1, 0),                         # 7
        S("krylov.sync", 60, 91, 1, 0),                          # 8
        S("solve", 120, 160, -1, 1),                             # 9
        S("krylov.sync", 130, 140, 9, 1),                        # 10
        S("gmg.vcycle", 141, 151, 9, 1, levels=2),               # 11
        S("gmg.level", 141, 150, 11, 1, level=0, shape=(9, 9)),  # 12
        S("gmg.level", 145, 149, 12, 1, level=1, shape=(5, 5)),  # 13
    ]
    host = [
        Event(WINDOW, 0, 100, 1, 0, 1),
        Event(PREFIX + "solve", 5, 95, 2, 0, 1),
        Event("cudaLaunchKernel", 13, 14, 101, 0, 1),
        Event("aten::mul", 41, 43, 7, 0, 1),
        Event("cudaLaunchKernel", 56, 56.5, 104, 0, 1),
        Event("aten::item", 60.5, 90, 5, 0, 1),
        Event("cudaMemcpyAsync", 61, 62, 103, 5, 1),
    ]
    device = [
        Event("sweep_kernel<2, 4, true>", 20, 30, 101, 0),
        Event("masked_laplace_kernel<float, 8>", 44, 50, 102, 7),
        Event("indexFuncLargeIndex", 56.5, 57.5, 104, 0),
        Event("Memcpy DtoH", 70, 72, 103, 5),
        Event(PREFIX + "solve", 5, 95, 2, 0),        # a device annotation
    ]
    return spans, device, host


def test_idle_split_piecewise_over_nested_and_sibling_spans():
    d = sp.join(*table(), T0)
    idle = dict(d.idle_by_span)
    # 81 µs idle: the annotation is not busy
    assert sum(idle.values()) == pytest.approx(81e-6)
    lv = "solve/krylov.outer_step/al.apply/al.block_solve/gmg.vcycle/"
    assert idle[lv + "gmg.level[0]"] == pytest.approx(18e-6)  # its own part
    assert idle[lv + "gmg.level[1]"] == pytest.approx(4e-6)   # the nested one
    assert idle["solve/krylov.outer_step/krylov.sync"] == pytest.approx(29e-6)
    assert idle["solve/krylov.outer_step"] == pytest.approx(10e-6)
    assert idle["solve/krylov.outer_step/coupling.rmv"] == pytest.approx(2e-6)
    assert idle["solve"] == pytest.approx(4e-6)
    assert idle["(no span)"] == pytest.approx(12e-6)
    assert d.vcycle_s_profiled == pytest.approx(35.5e-6)
    assert d.vcycle_idle_s == pytest.approx(22.5e-6)
    # inside the benchmark's solve range: 71 µs idle, 6 of it outside every
    # layer span (in the solve span's own time, or in none)
    assert d.solve_idle_s == pytest.approx(71e-6)
    assert d.solve_idle_unnamed_s == pytest.approx(6e-6)


def test_launches_charged_to_the_span_open_at_their_runtime_call():
    d = sp.join(*table(), T0)
    lv = {row["level"]: row for row in d.levels}
    assert lv[0]["device_ms"] == pytest.approx(0.010)
    assert lv[1]["device_ms"] == pytest.approx(0.006)     # by its linked op
    assert lv[0]["idle_ms"] == pytest.approx(0.018)
    assert lv[0]["shape"] == [9, 9]
    # host self time and visits from the solve after the profiled one
    assert lv[0]["host_self_ms"] == pytest.approx(0.005)
    assert lv[1]["host_self_ms"] == pytest.approx(0.004)
    assert lv[0]["visits"] == 1
    assert d.coupling_device_s == pytest.approx(1e-6)
    assert (d.syncs_profiled, d.syncs_with_copy) == (1, 1)


def test_profiled_and_later_solves():
    d = sp.join(*table(), T0)
    assert (d.profiled_solves, d.after_solves) == (1, 1)
    assert d.spans_per_solve == 5
    assert d.sync_s_after == pytest.approx(10e-6)
    assert d.vcycle_s_after == pytest.approx(10e-6)
    assert d.slowdown["solve"] == pytest.approx(88 / 40)


def test_readers():
    cell = spec.load_cell("laplace_circle.r12_f32")
    bare = Run()
    for name in sp.NEW_METRICS:
        assert cell.reader(name)(bare) is None
    run = Run(requests=[dict(ok=True, inner_iterations=19),
                        dict(ok=True, inner_iterations=22)])
    run.spans = sp.join(*table(), T0)
    got = {name: cell.reader(name)(run) for name in sp.NEW_METRICS}
    assert got == pytest.approx(dict(
        inner_iterations=20.5, sync_wait_ms_per_solve=0.010,
        vcycle_ms_per_solve=0.010,
        vcycle_device_idle_pct=100 * 22.5 / 35.5,
        coupling_device_ms_per_solve=0.001))


def test_traced_run_with_spans_on_the_cpu(bench_root):
    """Two profiled solves, then more with the tracer alone: every reading
    there, the program's state restored afterwards."""
    from fictitious_domain_al_preconditioners_torch import tracer

    from fdal_bench import run

    root, pkg = bench_root
    path = os.path.join(pkg, "workloads", "laplace_circle.r12_f32.json")
    with open(path) as fh:
        wl = json.load(fh)
    wl.update(trace_solves=2, sample_horizon=3)   # an answer after them
    with open(path, "w") as fh:
        json.dump(wl, fh)
    cell = spec.load_cell("laplace_circle.r12_f32", root=root,
                          package_dir=pkg)
    fam = cell.family()
    solve, events_of = fam.Driver.solve, run.events_of
    r, checks, _ = sp.traced_run(cell, 2 ** 31 + 5, 2.5, device="cpu")
    assert run.passed(checks)
    assert fam.Driver.solve is solve and run.events_of is events_of
    assert tracer.disable() == []                   # the tracer is off
    d = r.spans
    assert d.profiled_solves == 2 and d.after_solves >= 1
    assert r.mean("inner_iterations") > 0
    for name in sp.NEW_METRICS:
        assert cell.reader(name)(r) is not None
    # no device on the CPU: the V-cycles' time is all idle
    assert cell.reader("vcycle_device_idle_pct")(r) == pytest.approx(100.0)
    assert d.coupling_device_s == 0.0
    assert {row["level"] for row in d.levels} == set(
        range(len(d.levels)))
