"""The row-block sharded flagship solve of the PyTorch port
(``ImmersedLaplaceProblem.build_sharded_solver``) on 2, 3 and 4 gloo ranks
against the JAX package's serial solve and the port's own, in float64 on
the CPU with the JAX package's setup state and Lanczos vectors carried; the
JAX package's sharded solver on its 8-device virtual mesh against the port
on 4 ranks; ``dryrun_multichip``.  The other configurations have files of
their own: ``test_torch_sharded_forms.py`` (the lattice path's) and
``test_torch_sharded_flat.py`` (the element form).

JAX is imported inside the tests only: a spawned rank imports this module
to find its function, and every rank reports whether ``jax`` was loaded."""

import sys

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_torch.models import \
    ImmersedLaplaceProblem as TProblem
from fictitious_domain_al_preconditioners_torch.parallel import (
    launch, make_mesh)
from fictitious_domain_al_preconditioners_torch.parallel.dryrun import (
    SERIAL_LIMITS, compare_to_serial, dryrun_multichip, flagship_config,
    serial_reference, sharded_flagship_rank)
from fictitious_domain_al_preconditioners_torch.parallel.mesh import (
    Mesh, replicated)
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax

torch.set_num_threads(1)

CPU_MESH = Mesh(0, 1, None, torch.device("cpu"))


def _jax_problem(ref):
    """The JAX package's flagship problem of tests/test_parallel.py at
    ``ref``, set up, and its carried state."""
    from fictitious_domain_al_preconditioners_tpu.models import (
        ImmersedLaplaceConfig, ImmersedLaplaceProblem)
    from test_torch_immersed_laplace import carried_arrays

    cfg = flagship_config(ref)
    jcfg = ImmersedLaplaceConfig(
        initial_refinement=ref, initial_embedded_refinement=ref,
        embedded_configuration=cfg.embedded_configuration,
        embedding_rhs=cfg.embedding_rhs, embedded_value=cfg.embedded_value,
        solver="augmented", use_operator_form=True,
        use_diagonal_inverse=True)
    jp = ImmersedLaplaceProblem(jcfg).setup()
    return jp, carried_arrays(jp)


@pytest.fixture(scope="module")
def serial5():
    """At refinement 5: the JAX package's serial solve, the port's serial
    solve on the carried state, and that state."""
    jp, arrays = _jax_problem(5)
    uj, lamj, ij = jp.solve()
    tp = TProblem(flagship_config(5), device="cpu").setup()
    tp.load_state(state_from_jax(arrays, "cpu", torch.float64))
    ut, lamt, it = tp.solve()
    assert int(ij.iterations) == it.iterations
    return dict(arrays=arrays, iterations=int(ij.iterations),
                jax=(np.asarray(uj), np.asarray(lamj)),
                port=(ut.numpy(), lamt.numpy()))


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_sharded_flagship_matches_serial(ranks, serial5):
    """Equal outer count and u, λ within rtol 1e-9, atol 1e-11 of the JAX
    package's serial solve and of the port's (3 ranks: uneven blocks)."""
    results = launch(sharded_flagship_rank, ranks, backend="gloo",
                     device="cpu", args=(flagship_config(5),
                                         serial5["arrays"]), timeout=300)
    rows = [r["rows"] for r in results]
    assert rows[0][0] == 0 and rows[-1][1] == 33
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    if ranks == 3:
        assert len({hi - lo for lo, hi in rows}) > 1
    for res in results:
        assert not res["jax_loaded"]
        assert res["converged"] and res["world_size"] == ranks
        assert res["transport"] == "gloo" and res["compact_levels"] == 1
        assert res["iterations"] == serial5["iterations"]
        assert res["counts"]["halo_exchanges"] > 0
        assert res["counts"]["all_reduces"] > 0
        for ref_u, ref_lam in (serial5["jax"], serial5["port"]):
            np.testing.assert_allclose(res["lam"], ref_lam, rtol=1e-9,
                                       atol=1e-11)
            if res["rank"] == 0:
                np.testing.assert_allclose(res["u"], ref_u, rtol=1e-9,
                                           atol=1e-11)


def test_jax_sharded_solver_matches_port_on_4_ranks():
    """The JAX package's ``build_sharded_solver(make_mesh(8))`` at
    refinement 4 and the port's on 4 ranks (blocks of 4-5 rows, thinner
    than the sweeps' halo of 5)."""
    from fictitious_domain_al_preconditioners_tpu.parallel import \
        make_mesh as j_make_mesh

    jp, arrays = _jax_problem(4)
    u_s, lam_s, info_s = jp.build_sharded_solver(j_make_mesh(8))(
        jp.rhs_f, jp.rhs_g, jp.bc_values)
    results = launch(sharded_flagship_rank, 4, backend="gloo", device="cpu",
                     args=(flagship_config(4), arrays), timeout=300)
    assert [r["rows"][1] - r["rows"][0] for r in results] == [4, 4, 5, 4]
    for res in results:
        assert not res["jax_loaded"]
        assert res["iterations"] == int(info_s.iterations)
        np.testing.assert_allclose(res["lam"], np.asarray(lam_s), rtol=1e-9,
                                   atol=1e-11)
    np.testing.assert_allclose(results[0]["u"], np.asarray(u_s), rtol=1e-9,
                               atol=1e-11)


def test_compare_to_serial_holds_and_catches():
    """The comparison ``run_sharded_big_torch.py`` and ``chip_smoke.py``
    phase 16 share: at refinement 5 on 2 gloo ranks the sharded run lies
    within ``SERIAL_LIMITS`` of ``serial_reference`` (the operator probe
    bit-equal), and a wrong row of the operator probe, a wrong V-cycle
    probe, a wrong u and a changed count each fail it."""
    cfg = flagship_config(5)
    serial = serial_reference(cfg, "cpu", spread=True)
    assert serial["converged"] and serial["spread"] <= 1e-12
    assert serial["probe"]["op"].shape == (33, 33)
    res = launch(sharded_flagship_rank, 2, backend="gloo", device="cpu",
                 args=(cfg,), timeout=300)
    assert [r["probe"]["vcycle"].shape for r in res] == [(16, 33), (17, 33)]
    cmp = compare_to_serial(res, serial)
    assert cmp["failures"] == [] and cmp["limits"] == SERIAL_LIMITS[
        "float64"][2]
    assert cmp["drifts"]["op"] == 0.0 and cmp["drifts"]["iterations"] == 0

    def faulty(key):
        bad = [dict(r, probe=dict(r["probe"])) for r in res]
        if key in ("op", "vcycle"):
            bad[1]["probe"][key] = bad[1]["probe"][key].copy()
            bad[1]["probe"][key][0] *= 1.001    # the first row after the cut
        elif key == "u":
            bad[0]["u"] = bad[0]["u"] * (1 + 1e-6)
        else:
            bad[0]["iterations"] += 1
        return compare_to_serial(bad, serial)["failures"]

    for key in ("op", "vcycle", "u", "iterations"):
        assert [f.split(":")[0] for f in faulty(key)] == [key]


def test_replicated_is_the_whole_tensor():
    x = torch.arange(6.0).reshape(2, 3)
    y = replicated(CPU_MESH, x)
    assert y.device == CPU_MESH.device and torch.equal(y, x)


def test_dryrun_multichip_two_ranks():
    """No card here: two gloo ranks on the CPU run the three stages."""
    out = dryrun_multichip(2)
    assert [o["rank"] for o in out] == [0, 1]
    for o in out:
        assert o["transport"] == "gloo"
        assert o["al_cg_step"]["shape"] == [18, 17]
        assert o["two_level_step"]["shape"] == [17, 17]
        for stage in ("al_cg_step", "two_level_step"):
            assert o[stage]["drift"] <= 1e-9
        assert o["flagship"]["drift"] <= 1e-9
        assert o["flagship"]["counts"]["halo_exchanges"] > 0
        assert not o["flagship"]["jax_loaded"]
        assert o["flagship"]["iterations"] == out[0]["flagship"]["iterations"]
    assert out[0]["flagship"]["rows"] == [0, 8]


def test_make_mesh_raises_without_the_ranks():
    with pytest.raises(RuntimeError, match="2 ranks requested but only 1"):
        make_mesh(2, device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.transport) == (0, 1, "none")


def _failing_rank(mesh):
    """Rank 1 raises; rank 0 asks for more ranks than there are, then
    waits in a collective that rank 1 never joins (the parent stops it)."""
    assert "jax" not in sys.modules
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    with pytest.raises(RuntimeError, match="3 ranks requested but only 2"):
        make_mesh(3, device="cpu")
    mesh.all_reduce(torch.ones(1))
    return "unreachable"


def test_a_rank_failure_reaches_the_parent():
    with pytest.raises(RuntimeError) as info:
        launch(_failing_rank, 2, backend="gloo", device="cpu", timeout=120)
    text = str(info.value)
    assert "rank 1 of 2 failed" in text
    assert "ValueError: rank one fails on purpose" in text
    assert "_failing_rank" in text        # the rank's traceback


def test_one_rank_mesh_runs_in_process():
    """A one-rank mesh needs no process group: the sharded solver on it is
    the serial solve (the serial hierarchy is not built)."""
    prob = TProblem(flagship_config(4), device="cpu").setup()
    run = prob.build_sharded_solver(CPU_MESH)
    assert not hasattr(prob, "_last_gmg")
    u, lam, info = run(prob.rhs_f, prob.rhs_g, prob.bc_values)
    assert len(run.blocks) == 2 and len(run.gmg.tail.levels) == 1
    us, lams, infos = prob.solve()
    assert info.iterations == infos.iterations
    np.testing.assert_allclose(u.numpy(), us.numpy(), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(lam.numpy(), lams.numpy(), rtol=1e-9,
                               atol=1e-11)
