"""The V-cycle's CUDA graph on the card (``precond/gmg.py``): in the
flagship's float32 and bf16 hierarchies, the Stokes velocity hierarchy and
the elliptic problem's lattice, the graphed ``GMG.apply`` against the eager
recursion (the port's kernels the profiler sees run on the device in each,
and the launch counts of the graphed one), and whole solves with the graph
against solves without it: the same outer and inner counts, kernel
launches and records of the calls (the elliptic inner counts within a step
of the eager solves', which differ among themselves), one replay a
V-cycle, no failed capture, the device's peak grown by no more than the graph's two level-1
buffers, and the bytes the capture reserved.
A tail that cannot be captured leaves the cycle eager and counts the
failure.  Marked ``gpu``; without a card every test skips.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_vcycle_graph.py
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as S
from fictitious_domain_al_preconditioners_torch import tracer
from fictitious_domain_al_preconditioners_torch.models import (
    EllipticInterfaceProblem, ImmersedLaplaceProblem, StokesProblem)
from fictitious_domain_al_preconditioners_torch.ops import kernels as K
from fictitious_domain_al_preconditioners_torch.precond import gmg as G

pytestmark = pytest.mark.gpu

GRAPH_COUNTERS = ("vcycle_graph_replays", "vcycle_graph_captures",
                  "vcycle_graph_failures")
#: the port's CUDA kernels (``csrc/``)
PORT_KERNELS = ("sweep_kernel", "masked_laplace_kernel",
                "laplace_stencil_kernel", "augmented_op_kernel")


def _launch_key(kernel: str) -> str:
    """The ``LAUNCHES`` key of a launch of the CUDA kernel named
    ``kernel``."""
    if "augmented_op_kernel" in kernel:
        return K.launch_key("op")
    if "sweep_kernel" in kernel:
        mode, _, patch, storage = kernel.split("sweep_kernel<")[1] \
            .split(">")[0].split(", ")
        return K.launch_key(K.MODES[int(mode)], patch == "true",
                            storage == "__nv_bfloat16")
    base = ("masked_laplace_2d" if "masked_laplace_kernel" in kernel
            else "laplace_stencil_2d")
    form = kernel.split("_kernel<")[1].split(",")[0]
    return base + {"float": "", "__nv_bfloat16": ":bf16",
                   "double": ":f64"}[form]


def graph_counts(stats):
    return {k: stats.get(k, 0) for k in GRAPH_COUNTERS}


def _port_kernels(fn):
    """The port's kernels that ran on the device while ``fn`` ran, by name
    and count, as the profiler traced them (a graph's replays included)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and any(k in e.name for k in PORT_KERNELS))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def gmgs(monkeypatch):
    """Every :class:`G.GMG` built while the test runs, in order."""
    built = []
    init = G.GMG.__init__

    def recording(self, *args, **kw):
        init(self, *args, **kw)
        built.append(self)

    monkeypatch.setattr(G.GMG, "__init__", recording)
    return built


def laplace(device, bf16=False):
    return ImmersedLaplaceProblem(S.flagship_config(8, bf16=bf16),
                                  device=device).setup()


def stokes(device):
    return StokesProblem(S.stokes_config("5:6"), device=device,
                         dtype=torch.float32).setup()


def elliptic(device):
    return EllipticInterfaceProblem(S.elliptic_config(), device=device,
                                    dtype=torch.float32).setup(1)


PROBLEMS = {"laplace_f32": laplace,
            "laplace_bf16": lambda d: laplace(d, bf16=True),
            "stokes2d": stokes, "elliptic": elliptic}
#: the graphed cycle against the eager one, relative to its largest entry;
#: the hierarchy applied alone is each problem's first (the augmented
#: operator's, the velocity's, the background lattice's)
TOL = {"laplace_f32": 1e-6, "laplace_bf16": 2 ** -8, "stokes2d": 1e-6,
       "elliptic": 1e-6}


#: problems whose inner counts move by a step from one solve to the next,
#: graphed or not: the elliptic inner CGs stop at an absolute 1e-2, and on
#: the card the coupling's ``index_add_`` adds in no fixed order, so the
#: rounding that decides a stop differs from solve to solve
STEP_FROM_SOLVE_TO_SOLVE = {"elliptic"}


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _eager(gmg, b):
    """``gmg.apply(b)`` through the eager recursion, level by level."""
    gmg._below = lambda rc: gmg._vcycle(1, rc)
    try:
        return gmg.apply(b)
    finally:
        del gmg._below


def _level1_bytes(gmg):
    """The graph's two static buffers, each rounded up to the caching
    allocator's 512-byte blocks."""
    n = gmg.levels[1].mask.numel() * gmg.levels[1].mask.element_size()
    return 2 * (-(-n // 512) * 512)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_graphed_apply_is_the_eager_cycle(cuda, gmgs, name):
    prob = PROBLEMS[name](cuda)
    if name == "stokes2d":
        prob._al_parts()
    else:
        prob.solve()
    gmg = gmgs[0]
    if name == "elliptic":
        assert gmg.levels[0].mask.dim() == 2      # the K6 lattice
    assert len(gmg.levels) >= 3 and gmg._graph is not False
    # the flagship and elliptic solves captured already; Stokes' build not
    fresh = gmg._graph is None
    gmg.stats.clear()
    fine = gmg.levels[0].mask
    rng = np.random.default_rng(0)
    for _ in range(3):
        b = torch.as_tensor(rng.standard_normal(tuple(fine.shape)),
                            dtype=torch.float32, device=cuda) * fine.float()
        got = gmg.apply(b)
        ref = _eager(gmg, b)
        assert _rel(got, ref) <= TOL[name]
    assert graph_counts(gmg.stats) == dict(
        vcycle_graph_replays=3 - fresh, vcycle_graph_captures=int(fresh),
        vcycle_graph_failures=0)
    assert isinstance(gmg._graph, torch.cuda.CUDAGraph)
    # the same kernels ran on the device, those of the replay included, and
    # LAUNCHES, the replay's tally included, counts them (each wrapper call
    # launches one kernel)
    K.reset_launch_counts()
    graphed = _port_kernels(lambda: gmg.apply(b))
    launched = collections.Counter()
    for kernel, n in graphed.items():
        launched[_launch_key(kernel)] += n
    assert launched == +collections.Counter(K.LAUNCHES)
    assert graphed == _port_kernels(lambda: _eager(gmg, b))
    assert bool(graphed) == (name != "stokes2d")


def _solve(prob):
    """One solve with the tracer on: its counts, the launches of its kernel
    entries and their records (those a wrapper launched, recorded here
    instead of counted, with those the replays added), V-cycles and
    replays (spans), the bytes its captures reserved, and the device's peak
    over the solve less its memory before it."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    tracer.enable()
    try:
        with K.recording_launches() as rec:
            prob.solve()
    finally:
        spans = tracer.disable()
    torch.cuda.synchronize()
    r = prob.results
    return dict(
        counts=(r["outer_iterations"], r["inner_iterations"],
                r["host_syncs"]),
        launches=(collections.Counter(K.LAUNCHES)
                  + collections.Counter(key for key, _ in rec)),
        calls=collections.Counter(call for _, call in rec) + K.GRAPH_CALLS,
        vcycles=sum(s.name == "gmg.vcycle" for s in spans),
        graph_spans=sum(s.name == "gmg.graph" for s in spans),
        graph=graph_counts(r),
        pool_bytes=r["vcycle_graph_pool_bytes"],
        peak=torch.cuda.max_memory_allocated() - before)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_graphed_solve_is_the_eager_solve(cuda, gmgs, monkeypatch, name):
    prob = PROBLEMS[name](cuda)
    with monkeypatch.context() as m:
        m.setattr(G, "graph_eligible", lambda device, n: False)
        prob.solve()                         # builds the solver
        eagers = [_solve(prob) for _ in range(3)]
    eager = eagers[0]
    assert eager["graph"] == dict.fromkeys(GRAPH_COUNTERS, 0)
    assert eager["pool_bytes"] == 0 and not K.GRAPH_CALLS
    assert gmgs and all(g._graph is False for g in gmgs)
    for g in gmgs:
        g._graph = None
    captured = _solve(prob)
    graphed = _solve(prob)
    used = sum(isinstance(g._graph, torch.cuda.CUDAGraph) for g in gmgs)
    assert used >= 1
    assert captured["graph"] == dict(
        vcycle_graph_replays=captured["vcycles"] - used,
        vcycle_graph_captures=used, vcycle_graph_failures=0)
    assert graphed["graph"] == dict(
        vcycle_graph_replays=graphed["vcycles"], vcycle_graph_captures=0,
        vcycle_graph_failures=0)
    assert graphed["graph_spans"] == graphed["vcycles"] > 0
    print(name, "counts: eager", [e["counts"] for e in eagers], "captured",
          captured["counts"], "graphed", graphed["counts"], "peaks: eager",
          [e["peak"] for e in eagers], "captured", captured["peak"],
          "graphed", graphed["peak"])
    for run in (captured, graphed):
        if name in STEP_FROM_SOLVE_TO_SOLVE:
            # outer count equal; inner and syncs within a step of the eager
            # solves' own range; the same kernels and shapes launched
            assert run["counts"][0] == eager["counts"][0]
            for i in (1, 2):
                seen = [e["counts"][i] for e in eagers]
                assert min(seen) - 1 <= run["counts"][i] <= max(seen) + 1
            assert set(run["launches"]) == set(eager["launches"])
            assert set(run["calls"]) == set(eager["calls"])
        else:
            assert run["counts"] == eager["counts"]
            assert run["launches"] == eager["launches"]
            assert run["calls"] == eager["calls"]
    assert bool(graphed["calls"]) == (name != "stokes2d")
    # the static output and the tail's intermediates, in the graphs' pools
    assert captured["pool_bytes"] >= sum(
        _level1_bytes(g) // 2 for g in gmgs if g._static is not None)
    assert graphed["pool_bytes"] == 0
    # over the largest peak of the eager solves, which differ by the
    # Krylov code's allocations
    eager_peak = max(e["peak"] for e in eagers)
    buffers = sum(_level1_bytes(g) for g in gmgs if g._static is not None)
    assert graphed["peak"] <= eager_peak + buffers
    assert captured["peak"] <= eager_peak + buffers


def test_a_tail_that_cannot_be_captured_stays_eager(cuda, gmgs):
    """A coarse solve that reads the device from the host cannot be
    captured: the V-cycle counts the failure, returns the eager cycle's
    answer, and stays eager, its kernels still launching."""
    prob = laplace(cuda)
    prob.solve()
    gmg = gmgs[0]
    gmg._graph = None
    coarse_solve = gmg._coarse_solve

    def syncing(b):
        float(b.abs().max())
        return coarse_solve(b)

    gmg._coarse_solve = syncing
    gmg.stats.clear()
    fine = gmg.levels[0].mask
    b = torch.ones(tuple(fine.shape), device=cuda) * fine.float()
    got = gmg.apply(b)
    assert gmg._graph is False
    assert graph_counts(gmg.stats) == dict(
        vcycle_graph_replays=0, vcycle_graph_captures=0,
        vcycle_graph_failures=1)
    K.reset_launch_counts()
    again = gmg.apply(b)
    assert torch.equal(got, again)
    assert _rel(got, _eager(gmg, b)) <= 1e-6
    assert sum(K.LAUNCHES.values()) > 0
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
