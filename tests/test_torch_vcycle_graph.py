"""The V-cycle's CUDA graph (``precond/gmg.py``) on the CPU: the rule that
picks it, a pure function of the device and the hierarchy's depth; the
cycle it leaves as it was where the rule says no (every CPU run), with its
counters at 0; those counters in every family's ``results``; the record of
a capture's kernel-entry launches (``ops/kernels.py``) and what a replay
adds of it to the launch counts.  The graph itself is held to the eager
cycle on the card (``tests/test_torch_gpu_vcycle_graph.py``)."""

import collections
import functools
import types

import numpy as np
import pytest
import torch

import chip_smoke as S
from fictitious_domain_al_preconditioners_torch.models import (
    ElasticityInterfaceProblem, EllipticInterfaceProblem,
    ImmersedLaplaceProblem, NitscheProblem, StokesProblem)
from fictitious_domain_al_preconditioners_torch.models import \
    elliptic_interface
from fictitious_domain_al_preconditioners_torch.models.session import (
    SOLVE_COUNTERS, reset_solve_stats, solve_stats)
from fictitious_domain_al_preconditioners_torch.ops import kernels as K
from fictitious_domain_al_preconditioners_torch.precond import gmg as G

GRAPH_COUNTERS = [k for k in SOLVE_COUNTERS
                  if k.startswith("vcycle_graph")]
ZERO = dict.fromkeys(GRAPH_COUNTERS, 0)


def graph_counts(stats):
    return {k: stats.get(k, 0) for k in GRAPH_COUNTERS}


@pytest.mark.parametrize("device,n_levels,eligible", [
    ("cpu", 1, False), ("cpu", 11, False), (torch.device("cpu"), 2, False),
    ("cuda", 1, False), ("cuda", 2, True), ("cuda:0", 11, True),
    (torch.device("cuda", 0), 7, True)])
def test_graph_eligible(device, n_levels, eligible):
    assert G.graph_eligible(device, n_levels) is eligible


def eager_vcycle(gmg, li, b):
    """The cycle level by level, as :class:`G.GMG` ran it before the graph."""
    level = gmg.levels[li]
    if li == len(gmg.levels) - 1:
        return gmg._coarse_solve(b)
    sm = level.smoother
    if getattr(sm, "pre", None) is not None:
        x, r = sm.pre(b)
    else:
        x = sm(b)
        r = b - level.op(x)
    coarse = gmg.levels[li + 1]
    rc = (coarse.mask * coarse.prolong.rmv(r)).to(gmg.dtype)
    xc = eager_vcycle(gmg, li + 1, rc)
    x = x + (level.mask * coarse.prolong.mv(xc)).to(gmg.dtype)
    if getattr(sm, "post", None) is not None:
        return sm.post(b, x)
    return x + sm(b - level.op(x))


@functools.cache
def laplace(bf16: bool):
    prob = ImmersedLaplaceProblem(S.flagship_config(5, bf16=bf16),
                                  device="cpu", dtype=torch.float32).setup()
    prob.solve()
    return prob


@functools.cache
def stokes():
    return StokesProblem(S.stokes_config("4:5"), device="cpu",
                         dtype=torch.float32).setup()


@functools.cache
def elliptic():
    """The elliptic problem at cycle 0 on the CPU (float64) and the GMGs
    its solver built, in order: the background lattice's first."""
    built = []
    build = elliptic_interface.build_gmg

    def recording(*args, **kw):
        built.append(build(*args, **kw))
        return built[-1]

    elliptic_interface.build_gmg = recording
    try:
        prob = EllipticInterfaceProblem(S.elliptic_config(),
                                        device="cpu").setup(0)
        prob.solve()
    finally:
        elliptic_interface.build_gmg = build
    return prob, built


HIERARCHIES = {
    "laplace_f32": lambda: laplace(False)._last_gmg,
    "laplace_bf16": lambda: laplace(True)._last_gmg,
    "stokes2d": lambda: stokes()._al_parts()["gmg"],
    "elliptic_f64": lambda: elliptic()[1][0],
}


@pytest.mark.parametrize("name", list(HIERARCHIES))
def test_cpu_apply_is_the_eager_cycle(name):
    gmg = HIERARCHIES[name]()
    assert len(gmg.levels) >= 2
    fine = gmg.levels[0].mask
    dtype = gmg.coarse_inv.dtype
    if name == "elliptic_f64":
        assert gmg.dtype == torch.float64 and fine.dim() == 2
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.standard_normal(tuple(fine.shape)),
                        dtype=dtype) * fine.to(dtype)
    got = gmg.apply(b)
    ref = eager_vcycle(gmg, 0, b.to(gmg.dtype)).to(b.dtype)
    assert torch.equal(got, ref)
    assert gmg._graph is False
    assert graph_counts(gmg.stats) == ZERO


@pytest.mark.parametrize("name", list(HIERARCHIES))
def test_coarse_solve_is_the_dense_inverse_applied(name):
    gmg = HIERARCHIES[name]()
    coarse = gmg.levels[-1].mask
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(tuple(coarse.shape)),
                        dtype=gmg.dtype)
    got = gmg._coarse_solve(b)
    ref = (gmg.coarse_inv.double() @ b.reshape(-1).double()).reshape(
        b.shape)
    assert got.dtype == gmg.dtype and got.shape == b.shape
    tol = {torch.float64: 1e-13, torch.float32: 1e-5,
           torch.bfloat16: 2 ** -7}[gmg.dtype]
    assert float((got.double() - ref).abs().max()) <= tol * float(
        ref.abs().max())


def _laplace_refined():
    prob = laplace(False)
    prob.solve_refined(tol_abs=1e-8)
    return prob.results


def _nitsche():
    prob = NitscheProblem(S.nitsche_config(), device="cpu",
                          dtype=torch.float32).setup(0)
    prob.solve_refined()
    return prob.results


def _elasticity():
    prob = ElasticityInterfaceProblem(S.elasticity_config(small=True),
                                      device="cpu",
                                      dtype=torch.float32).setup()
    prob.solve()
    return prob.results


def _solved(prob):
    prob.solve()
    return prob.results


FAMILIES = {
    "immersed_laplace": lambda: _solved(laplace(False)),
    "immersed_laplace_bf16": lambda: _solved(laplace(True)),
    "immersed_laplace_refined": _laplace_refined,
    "elliptic": lambda: _solved(elliptic()[0]),
    "stokes": lambda: _solved(stokes()),
    "nitsche": _nitsche,
    "elasticity": _elasticity,
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_reports_the_graph_counters(family):
    results = FAMILIES[family]()
    assert results["inner_iterations"] > 0 and results["host_syncs"] > 0
    assert graph_counts(results) == ZERO


def test_solve_stats_are_reset_and_reported_together():
    stats = {"host_syncs": 7, "vcycle_graph_replays": 3, "other": 1}
    reset_solve_stats(stats)
    assert stats == dict(dict.fromkeys(SOLVE_COUNTERS, 0), other=1)
    stats["inner_iterations"] += 5
    assert solve_stats(stats) == dict(
        dict.fromkeys(SOLVE_COUNTERS, 0), inner_iterations=5)
    assert {"host_syncs", "inner_iterations", "vcycle_graph_replays",
            "vcycle_graph_captures", "vcycle_graph_failures",
            "vcycle_graph_pool_bytes"} == set(SOLVE_COUNTERS)


def _stencil(shape=(9, 11), box=(2, 3, 4, 5)):
    return types.SimpleNamespace(shape=shape, box=box)


#: (entry, tensor, extra fields of its record) of each kernel entry
ENTRIES = {
    "K1": ("masked_laplace_2d", torch.zeros(9, 11), {}),
    "K1_bf16": ("masked_laplace_2d",
                torch.zeros(9, 11, dtype=torch.bfloat16), {}),
    "K6_f64": ("laplace_stencil_2d",
               torch.zeros(5, 7, dtype=torch.float64), {}),
    "K2_pre": ("fused_augmented_2d", torch.zeros(9, 11),
               dict(mode="pre", box=(2, 3, 4, 5), degree=4)),
    "K2_op": ("fused_augmented_2d", torch.zeros(9, 11),
              dict(mode="op", box=(0, 0, 0, 0), degree=4)),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_call_record_is_the_benchmark_record(entry):
    """A capture's record of a call is the record the benchmark's wrappers
    keep of the same call (``fdal_bench/trace.py::KernelCalls``), and its
    bound (``fdal_bench/roofline.py``) is the same."""
    from fdal_bench import roofline
    from fdal_bench.trace import KernelCalls

    name, t, extra = ENTRIES[entry]
    calls = KernelCalls()
    wrapped = calls._wrap(name, lambda *a, **kw: None)
    if name == "fused_augmented_2d":
        wrapped(extra["mode"], _stencil(t.shape, extra["box"]), t,
                degree=extra["degree"])
    else:
        wrapped(t, 0.1)
    bench = {k: tuple(v) if isinstance(v, list) else v
             for k, v in calls.calls[0].items()}
    bench["cuda"] = True              # recorded only for card tensors
    record = K.call_record(name, t, **extra)
    assert dict(record) == bench
    assert hash(record) == hash(K.call_record(name, t.clone(), **extra))
    assert roofline.call_bound_s(dict(record)) == roofline.call_bound_s(
        calls.calls[0])


@pytest.mark.parametrize("bf16", [False, True])
def test_the_benchmark_wrappers_see_every_fused_smoother_call(bf16):
    """Each K2 ``pre`` and ``post`` of a V-cycle calls the kernel's entry
    as its module holds it at the call, where the benchmark's call wrappers
    (``fdal_bench/trace.py::KernelCalls``) put themselves: one of each a
    visit of a fused level."""
    from fdal_bench.trace import KernelCalls

    gmg = laplace(bf16)._last_gmg
    fused = [tuple(lv.mask.shape) for lv in gmg.levels[:-1]
             if isinstance(lv.smoother, G.FusedSmoother)]
    assert fused
    fine = gmg.levels[0].mask
    b = torch.ones(tuple(fine.shape), dtype=torch.float32) * fine.float()
    calls = KernelCalls().install()
    try:
        gmg.apply(b)
    finally:
        calls.uninstall()
    seen = collections.Counter(
        (c["mode"], tuple(c["shape"])) for c in calls.calls
        if c["kernel"] == "fused_augmented_2d")
    assert {k: n for k, n in seen.items() if k[0] in ("pre", "post")} == {
        (mode, shape): 1 for shape in fused for mode in ("pre", "post")}


def test_a_capture_records_its_launches_instead_of_counting_them():
    K.reset_launch_counts()
    rec = K.call_record("masked_laplace_2d", torch.zeros(5, 5))
    K._launched("masked_laplace_2d", lambda: rec)
    with K.recording_launches() as outer:
        K._launched("masked_laplace_2d", lambda: rec)
        with K.recording_launches() as inner:
            K._launched("laplace_stencil_2d", lambda: "inner")
        K._launched("fused_augmented_2d:pre", lambda: "outer")
    K._launched("masked_laplace_2d", lambda: rec)
    assert inner == [("laplace_stencil_2d", "inner")]
    assert outer == [("masked_laplace_2d", rec),
                     ("fused_augmented_2d:pre", "outer")]
    assert K.LAUNCHES["masked_laplace_2d"] == 2
    assert sum(K.LAUNCHES.values()) == 2
    assert K._recording is None
    K.GRAPH_CALLS[rec] += 1
    K.reset_launch_counts()
    assert not K.GRAPH_CALLS and sum(K.LAUNCHES.values()) == 0


class _FakeGraph:
    """Stands in for a captured graph on the CPU: ``replay`` writes twice
    the static input into the static output."""

    def __init__(self, static_in, static_out):
        self.io = (static_in, static_out)
        self.replays = 0

    def replay(self):
        self.io[1].copy_(2 * self.io[0])
        self.replays += 1


@pytest.mark.parametrize("replays", [1, 3])
def test_a_replay_adds_its_capture_record(replays):
    """Each replay adds the launches its capture recorded to ``LAUNCHES``
    and ``GRAPH_CALLS``, and counts one replay in the solve's stats."""
    K.reset_launch_counts()
    stats = {}
    reset_solve_stats(stats)
    gmg = G.GMG([None, None], torch.eye(4), torch.float64, stats)
    static = (torch.zeros(2, 2, dtype=torch.float64),
              torch.zeros(2, 2, dtype=torch.float64))
    gmg._graph = _FakeGraph(*static)
    gmg._static = static
    k1 = K.call_record("masked_laplace_2d", torch.zeros(3, 3))
    k2 = K.call_record("fused_augmented_2d", torch.zeros(3, 3), mode="pre",
                       box=(0, 0, 0, 0), degree=4)
    gmg._tally = collections.Counter({"masked_laplace_2d": 2,
                                      "fused_augmented_2d:pre:no_patch": 1})
    gmg._calls = collections.Counter({k1: 2, k2: 1})
    rc = torch.arange(4, dtype=torch.float64).reshape(2, 2)
    for _ in range(replays):
        out = gmg._below(rc)
    assert out is static[1] and torch.equal(out, 2 * rc)
    assert gmg._graph.replays == replays
    assert K.LAUNCHES["masked_laplace_2d"] == 2 * replays
    assert K.LAUNCHES["fused_augmented_2d:pre:no_patch"] == replays
    assert K.GRAPH_CALLS == {k1: 2 * replays, k2: replays}
    assert solve_stats(stats)["vcycle_graph_replays"] == replays
    K.reset_launch_counts()
