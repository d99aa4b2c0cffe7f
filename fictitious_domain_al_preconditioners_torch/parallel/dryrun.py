"""Multi-rank dry run of the sharded solve paths, and the rank function of
the sharded flagship solve.

Counterpart of ``dryrun_multichip`` and ``_dryrun_impl`` of the JAX
package's ``__graft_entry__.py``.  :func:`dryrun_multichip` starts ``n``
ranks itself (:func:`..parallel.mesh.launch`): ``nccl`` ranks, one a card,
when at least ``n`` cards are visible, else ``gloo`` ranks on the CPU in
float64.  Each runs the three stages of the JAX dry run: the sharded AL CG
step at refinement 4, the sharded two-level PCG step, and the sharded
flagship solve at refinement 4 against the serial solve.

:func:`sharded_flagship_rank` is what one rank of a sharded run of any
augmented configuration does (the dry run's third stage,
``scripts/run_sharded_big_torch.py``, ``chip_smoke.py`` phase 16 and the
tests call it through ``launch``; :func:`sharded_runs_rank` runs several
in one start of the ranks); :func:`serial_reference` and
:func:`compare_to_serial` hold such a run to the serial solve, for the
script and phase 16 alike.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from .mesh import (Mesh, launch, padded_shape, sharded_al_cg_step,
                   sharded_two_level_step)

__all__ = ["flagship_config", "sharded_flagship_rank", "sharded_runs_rank",
           "serial_reference", "compare_to_serial", "SERIAL_LIMITS",
           "dryrun_multichip"]

CIRCLE = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")

#: the seed of the probe vector: one application of the fine level's
#: operator (K2 ``op``) and one V-cycle, on the whole lattice serially and
#: on each rank's rows sharded (:func:`probe_vector`)
PROBE_SEED = 1650

#: how far a sharded flagship run may lie from the serial solve of the same
#: problem (:func:`compare_to_serial`), by working dtype and world size (1,
#: or 2 for any more): outer ``iterations``, and the relative max-norm
#: difference of ``u``, of the probe's operator (``op``) and of its V-cycle
#: (``vcycle``).  In float64 every sum order gives the same digits to
#: 1e-9.  In float32 one rank is bit-equal to a deterministic serial solve;
#: with more, the all-reduced sums change the last bits, the inner CGs'
#: absolute stop (1e-2) moves with them, and u moves by about the outer
#: rule's own size: two ranks 9.52e-5 to 9.92e-5 from the serial solve,
#: and two serial solves of one problem 9.95e-5 and 1.40e-4 apart (NVIDIA
#: H100 80GB HBM3, 700 W; PERF.md §6).  The probes take no inner stop, so
#: they see a halo fault that the u limit cannot tell from rounding: two
#: ranks read 3.5e-8 (op) and 7.4e-7 (vcycle) there, a halo one row short
#: 0.12 and 1.3e-3 (float64, on the CPU).  A configuration with limits of
#: its own is keyed ``"<dtype>:<name>"``.  The bf16 V-cycle (``bf16``): its
#: Lanczos bounds are float32 sums, all-reduced over the ranks, whose last
#: bits move the Chebyshev coefficients enough to flip single bf16 roundings:
#: the V-cycle probe 4.4e-3 from the serial one (about one bf16 ulp at the
#: largest entry) and u 1.1e-4 at refinement 6 under the flagship's rule on
#: 2 ranks (float64 outer, CPU); at 12 on the card 9.6e-3 and u 1.05e-3,
#: where two serial bf16 solves of one problem lie 1.34e-3 apart (H100,
#: 700 W; PERF.md §6).  Its operator probe stays bit-equal, and sees a halo
#: fault.  The other configurations of ``chip_smoke.py`` phase 16 read
#: within the float32 limits (u 9.2e-6 to 9.0e-5, op at most 1.2e-7,
#: V-cycle at most 7.4e-7).
SERIAL_LIMITS = {
    "float64": {1: dict(iterations=0, u=1e-9, op=1e-12, vcycle=1e-12),
                2: dict(iterations=0, u=1e-9, op=1e-12, vcycle=1e-12)},
    "float32": {1: dict(iterations=0, u=1e-5, op=1e-6, vcycle=1e-6),
                2: dict(iterations=1, u=5e-4, op=1e-6, vcycle=1e-5)},
    "float64:bf16": {1: dict(iterations=0, u=1e-9, op=1e-12, vcycle=1e-12),
                     2: dict(iterations=1, u=5e-4, op=1e-12, vcycle=2e-2)},
    "float32:bf16": {1: dict(iterations=0, u=1e-5, op=1e-6, vcycle=1e-6),
                     2: dict(iterations=1, u=5e-3, op=1e-6, vcycle=2e-2)}}


def flagship_config(refinement: int, **control):
    """The flagship configuration of the JAX dry run (``bench.py``'s circle,
    smooth data, ``augmented`` in operator form with W = diag(M)); keyword
    arguments set the outer solver's controls (``tolerance``,
    ``reduction``, ``max_steps``)."""
    from ..models.immersed_laplace import (ImmersedLaplaceConfig,
                                           SolverControlConfig)

    return ImmersedLaplaceConfig(
        initial_refinement=refinement,
        initial_embedded_refinement=refinement,
        embedded_configuration=CIRCLE,
        embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
        embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
        solver="augmented", use_operator_form=True,
        use_diagonal_inverse=True, schur=SolverControlConfig(**control))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms on (on a card ``index_add_``'s
    sorted form: its float32 atomics reorder the sums of C and Cᵀ from one
    run to the next), as they were after."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def probe_vector(shape, dtype, device) -> torch.Tensor:
    """The probe: standard normal on the whole fine lattice, from
    :data:`PROBE_SEED`."""
    rng = np.random.default_rng(PROBE_SEED)
    return torch.as_tensor(rng.standard_normal(tuple(shape)), dtype=dtype,
                           device=device)


def _apply_probe(gmg, x) -> dict:
    """The probe through a hierarchy's fine operator (in the V-cycle's
    dtype: the bf16 levels take bf16) and one V-cycle, float64 NumPy."""
    return {k: f(x).double().cpu().numpy() for k, f in (
        ("op", lambda v: gmg.levels[0].op(v.to(gmg.dtype))),
        ("vcycle", gmg.apply))}


def probe_shape(prob) -> tuple:
    """The fine level vector's shape: the lattice, or flat on the element
    form."""
    from .lattice import LatticeOps

    if prob.element_form:
        return (prob.space.n_dofs,)
    return LatticeOps.for_space(prob.space).shape


def serial_reference(cfg, device, spread: bool = False,
                     state_arrays=None) -> dict:
    """The serial augmented solve of ``cfg`` (any configuration of
    ``ImmersedLaplaceProblem.build_sharded_solver``; with ``state_arrays``
    on the JAX package's setup state) that a sharded
    run is held to, with deterministic algorithms: its outer
    ``outer_iterations``, ``converged``, ``u`` and ``lam`` (float64 NumPy),
    the ``probe`` (the fine level's operator and one V-cycle on
    :func:`probe_vector`), seconds and dofs.  With ``spread`` a second
    solve of the same problem with them off adds ``spread`` (its u's
    relative max-norm difference: the serial path's own spread from run to
    run) and ``spread_outer_iterations``."""
    from ..models.immersed_laplace import ImmersedLaplaceProblem
    from ..utils.carry import state_from_jax

    with _deterministic():
        t0 = time.perf_counter()
        prob = ImmersedLaplaceProblem(cfg, device=device).setup()
        if state_arrays is not None:
            prob.load_state(state_from_jax(state_arrays, prob.device,
                                           prob.dtype))
        setup_s = time.perf_counter() - t0
        u, lam, info = prob.solve()
        gmg = prob._last_gmg
        x = probe_vector(probe_shape(prob), prob.dtype, prob.device)
        probe = _apply_probe(gmg, x)
    u = u.double().cpu().numpy()
    out = dict(outer_iterations=int(info.iterations),
               converged=bool(info.converged), u=u,
               lam=lam.double().cpu().numpy(), probe=probe,
               setup_seconds=setup_s,
               build_seconds=prob.results["build_seconds"],
               solve_seconds=prob.results["solve_seconds"],
               dofs_background=prob.space.n_dofs,
               dofs_immersed=prob.imm_space.n_dofs)
    if spread:
        u2, _, info2 = prob.solve()
        out.update(spread=float(np.abs(u2.double().cpu().numpy() - u).max()
                                / np.abs(u).max()),
                   spread_outer_iterations=int(info2.iterations))
    return out


def compare_to_serial(res: list, serial: dict, name: str | None = None
                      ) -> dict:
    """Hold a sharded run (``res``: every rank's result of
    :func:`sharded_flagship_rank`) to ``serial``
    (:func:`serial_reference`) within :data:`SERIAL_LIMITS` (those of the
    configuration ``name`` where it has its own): returns the ``drifts``
    (outer iterations apart; relative max-norm of u and of the probes, the
    ranks' rows stacked), the ``limits`` and the ``failures`` (empty when
    the run holds)."""
    def rel(a, ref):
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    r0 = res[0]
    limits = SERIAL_LIMITS.get(f"{r0['dtype']}:{name}",
                               SERIAL_LIMITS[r0["dtype"]])[min(len(res), 2)]
    drifts = dict(
        iterations=abs(r0["iterations"] - serial["outer_iterations"]),
        u=rel(r0["u"], serial["u"]),
        **{k: rel(np.concatenate([r["probe"][k] for r in res]),
                  serial["probe"][k]) for k in ("op", "vcycle")})
    failures = [] if r0["converged"] else ["the sharded solve did not "
                                           "converge"]
    failures += [f"{k}: {v:.3e} from the serial solve > {limits[k]}"
                 for k, v in drifts.items() if v > limits[k]]
    return dict(drifts=drifts, limits=limits, failures=failures)


def sharded_flagship_rank(mesh: Mesh, cfg, state_arrays=None,
                          serial: bool = False, keep=None) -> dict:
    """One rank of the sharded augmented solve of ``cfg`` (the flagship, or
    any configuration ``build_sharded_solver`` takes) on
    ``mesh.device`` (float64 on the CPU, float32 on a card): set up the
    problem (with ``state_arrays``, the JAX package's setup state, loaded
    by ``utils.carry.state_from_jax``), build the sharded solver, solve
    once, and return NumPy ``u`` and ``lam``, the outer ``iterations``,
    ``residual`` and ``converged``, setup, build and solve seconds, the
    mesh's collective counts during the solve, this rank's kernel launches
    over setup, build and solve, its rows, its peak device GB and whether
    ``jax`` was imported (``u``, the same on every rank, on rank 0 only).
    With ``serial`` the rank also runs the serial solve (after the sharded
    one) and adds its ``serial_iterations``, ``serial_seconds`` and the
    largest difference of the two ``u``, relative to the serial one's
    largest entry (``serial_drift``).  ``probe`` holds this rank's rows of
    the probe (:func:`serial_reference`) through the sharded hierarchy.
    ``keep(prob, run, out)`` may add entries (run on the rank,
    after the sharded solve).  Deterministic algorithms are on throughout,
    as in :func:`serial_reference`."""
    with _deterministic():
        return _sharded_flagship_rank(mesh, cfg, state_arrays, serial, keep)


def sharded_runs_rank(mesh: Mesh, runs, keep=None) -> list:
    """:func:`sharded_flagship_rank` of each ``(cfg, state_arrays)`` of
    ``runs`` in turn, in one start of the ranks; their results in order
    (each run's launch counts and peak memory its own)."""
    return [sharded_flagship_rank(mesh, cfg, arrays, keep=keep)
            for cfg, arrays in runs]


def _sharded_flagship_rank(mesh, cfg, state_arrays, serial, keep):
    from ..models.immersed_laplace import ImmersedLaplaceProblem
    from ..ops.kernels import LAUNCHES, reset_launch_counts
    from ..utils.carry import state_from_jax

    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    prob = ImmersedLaplaceProblem(cfg, device=dev).setup()
    if state_arrays is not None:
        prob.load_state(state_from_jax(state_arrays, dev, prob.dtype))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = prob.build_sharded_solver(mesh)
    _sync(dev)
    build_s = time.perf_counter() - t0
    mesh.reset_counts()
    prob.stats["host_syncs"] = 0
    t0 = time.perf_counter()
    u, lam, info = run(prob.rhs_f, prob.rhs_g, prob.bc_values)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    out = dict(
        rank=mesh.rank, world_size=mesh.size, backend=mesh.backend,
        transport=mesh.transport, device=str(dev),
        dtype=str(prob.dtype).replace("torch.", ""),
        refinement=cfg.initial_refinement,
        dofs_background=prob.space.n_dofs,
        dofs_immersed=prob.imm_space.n_dofs,
        rows=list(run.blocks[0].rows(mesh.rank)),
        distributed_levels=len(run.blocks),
        levels=(len(run.gmg.levels) + len(run.gmg.tail.levels)
                - run.gmg.direct),
        level_kinds=[lv["kind"] for lv in prob.sharded_levels],
        iterations=int(info.iterations), residual=float(info.residual),
        converged=bool(info.converged), setup_seconds=setup_s,
        build_seconds=build_s, solve_seconds=solve_s,
        host_syncs=prob.stats["host_syncs"], counts=dict(mesh.counts),
        launches={k: v for k, v in LAUNCHES.items() if v},
        peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                 if dev.type == "cuda" else None),
        compact_levels=len(prob.compact_blocks),
        jax_loaded="jax" in sys.modules
        or "fictitious_domain_al_preconditioners_tpu" in sys.modules,
        lam=lam.double().cpu().numpy(),
        u=u.double().cpu().numpy() if mesh.rank == 0 else None)
    lo, hi = run.blocks[0].rows(mesh.rank)
    x = probe_vector(probe_shape(prob), prob.dtype, dev)[lo:hi].contiguous()
    out["probe"] = _apply_probe(run.gmg, x)
    if keep is not None:
        keep(prob, run, out)
    if serial:
        us, _, sinfo = prob.solve()
        scale = float(us.abs().max()) or 1.0
        out.update(serial_iterations=int(sinfo.iterations),
                   serial_seconds=prob.results["solve_seconds"],
                   serial_drift=float((u - us).abs().max()) / scale)
    return out


def _dryrun_rank(mesh: Mesh) -> dict:
    """The three stages of the JAX dry run on this rank; returns what each
    stage found (the same on every rank)."""
    from ..core import GridSpace, UniformGrid, parametrized_curve
    from ..ops.coupling import build_coupling
    from .lattice import LatticeOps

    dev = mesh.device
    dt = torch.float64 if dev.type == "cpu" else torch.float32
    tol = 1e-9 if dt == torch.float64 else 1e-4
    space = GridSpace.q(UniformGrid.hyper_cube(2, 0.0, 1.0, 4), 1)

    def conf(pts):
        s = pts[:, 0]
        return np.stack([0.2 * np.cos(2 * np.pi * s) + 0.4,
                         0.2 * np.sin(2 * np.pi * s) + 0.4], axis=1)

    curve = parametrized_curve(conf, refinement=4)
    C = build_coupling(space, curve.space(1), 3, device=dev, dtype=dt)
    pshape = padded_shape(space.n_points_1d, mesh)
    lat = LatticeOps.for_space(space, padded=pshape)
    rng = np.random.default_rng(0)
    b = lat.pad(torch.as_tensor(rng.standard_normal(
        tuple(reversed(space.n_points_1d))), dtype=dt, device=dev))
    out = {"rank": mesh.rank, "world_size": mesh.size,
           "transport": mesh.transport}
    for name, make in (
            ("al_cg_step", lambda m: sharded_al_cg_step(
                m, lat, C, gamma=10.0 / curve.h_max, n_cg=5)),
            ("two_level_step", lambda m: sharded_two_level_step(
                m, LatticeOps.for_space(space),
                LatticeOps.for_space(space.coarse_space()), n_cg=3,
                jacobi_diag=3.0 / 8.0))):
        arg = b if name == "al_cg_step" else lat.unpad(b)
        x = make(mesh)(arg)
        ref = make(Mesh(0, 1, None, dev))(arg)      # the same step unsharded
        drift = float((x - ref).abs().max() / ref.abs().max())
        if not (bool(torch.isfinite(x).all()) and x.shape == ref.shape
                and drift <= tol):
            raise AssertionError(f"{name}: sharded against unsharded drift "
                                 f"{drift:.3e} (shape {tuple(x.shape)})")
        out[name] = dict(shape=list(x.shape), drift=drift)
    res = sharded_flagship_rank(mesh, flagship_config(4), serial=True)
    if not res["converged"]:
        raise AssertionError("sharded flagship solve did not converge")
    if res["iterations"] != res["serial_iterations"]:
        raise AssertionError("sharded vs serial outer iteration mismatch: "
                             f"{res['iterations']} != "
                             f"{res['serial_iterations']}")
    if res["serial_drift"] > tol:
        raise AssertionError("sharded vs serial solution drift: "
                             f"{res['serial_drift']}")
    out["flagship"] = dict(iterations=res["iterations"],
                           drift=res["serial_drift"],
                           rows=res["rows"],
                           distributed_levels=res["distributed_levels"],
                           counts=res["counts"],
                           jax_loaded=res["jax_loaded"])
    return out


def dryrun_multichip(n_devices: int, timeout: float = 900.0) -> list:
    """Run the three stages of the JAX dry run on ``n_devices`` ranks and
    return each rank's findings.  The ranks are ``nccl`` ranks, one a card,
    when ``torch.cuda.device_count() >= n_devices``, else ``gloo`` ranks on
    the CPU (float64): chosen by the count of cards, not by catching a
    failure.  A stage that fails raises here with the rank's traceback."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend, device = (("nccl", "cuda") if cards >= n_devices
                       else ("gloo", "cpu"))
    if device == "cuda":
        from ..ops.kernels import build

        build()       # once, before the ranks start
    return launch(_dryrun_rank, n_devices, backend=backend, device=device,
                  timeout=timeout)
