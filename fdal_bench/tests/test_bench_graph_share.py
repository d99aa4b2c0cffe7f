"""``kernel_graph_share_pct``: the share of the kernel entries' work that
ran inside CUDA graph replays, read from the program's count of replayed
calls (``ops.kernels.GRAPH_CALLS``) beside the traced window's calls; and
nothing, without raising, from a program that keeps no such count."""

import collections

import pytest
import torch

from fdal_bench import roofline, spec
from fdal_bench.trace import TraceData
from fdal_bench.window import Run
from fictitious_domain_al_preconditioners_torch.ops import kernels

K2 = dict(kernel="fused_augmented_2d", mode="pre", shape=[4097, 4097],
          box=[1000, 1100, 900, 800], degree=4, dtype="float32", cuda=True)


def read(run):
    return spec.load_cell("laplace_circle.r12_f32").reader(
        "kernel_graph_share_pct")(run)


def traced_run(solves, attempted, calls):
    run = Run(requests=[dict(ok=True, seconds=0.1)] * attempted)
    run.trace = TraceData(window_s=1.0, busy_s=0.5, solves=solves,
                          kernel_calls=calls, kernel_device_s=0.01)
    return run


@pytest.fixture
def replayed(monkeypatch):
    counter = collections.Counter()
    monkeypatch.setattr(kernels, "GRAPH_CALLS", counter)
    return counter


def test_the_share_of_replayed_work(replayed):
    level1 = kernels.call_record("fused_augmented_2d",
                                 torch.empty(2049, 2049), mode="pre",
                                 box=(500, 550, 450, 400), degree=4)
    replayed[level1] = 3 * 10          # 10 a solve over 2 + the warm one
    run = traced_run(solves=1, attempted=2, calls=[K2, dict(K2, cuda=False)])
    graph = 10 * roofline.call_bound_s(dict(level1))
    eager = roofline.call_bound_s(K2)
    assert read(run) == pytest.approx(100 * graph / (graph + eager))


def test_nothing_replayed_reads_zero(replayed):
    assert read(traced_run(solves=2, attempted=5, calls=[K2])) == 0.0


def test_no_kernel_work_or_no_trace_reads_nothing(replayed):
    assert read(traced_run(solves=2, attempted=5, calls=[])) is None
    assert read(Run(requests=[dict(ok=True, seconds=0.1)])) is None


def test_a_program_without_the_count_reads_nothing(monkeypatch):
    monkeypatch.delattr(kernels, "GRAPH_CALLS")
    assert read(traced_run(solves=2, attempted=5, calls=[K2])) is None
