"""The float64 reference against the port on the CPU: the same system
(operator and right-hand side, to round-off, against the port's host
float64 systems) and the port's float64 solves judged converged."""

import json
import os

import numpy as np
import pytest
import torch

from fdal_bench import spec
from fdal_bench.families import immersed_laplace, stokes
from fdal_bench.reference.laplace import LaplaceReference
from fdal_bench.reference.stokes import StokesReference
from fictitious_domain_al_preconditioners_torch.ops.host_ref import (
    HostAugmentedSystem, HostStokesSystem)


def _config(name, ref, eref):
    with open(os.path.join(spec.PACKAGE_DIR, "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    cfg["problem"]["initial_refinement"] = ref
    cfg["problem"]["initial_embedded_refinement"] = eref
    return cfg


def _modes(name):
    with open(os.path.join(spec.PACKAGE_DIR, "traffic", f"{name}.json")) as fh:
        return json.load(fh)["modes"]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.mark.parametrize("ref", [5, 6])
def test_laplace_reference_is_the_ports_system(ref):
    cfg, modes = _config("laplace_circle", ref, ref), _modes("laplace_modes")
    prob = immersed_laplace.config_of(cfg["problem"])
    from fictitious_domain_al_preconditioners_torch.models import \
        ImmersedLaplaceProblem

    p = ImmersedLaplaceProblem(prob, device="cpu").setup()   # float64
    R = LaplaceReference(cfg["problem"], modes, "cpu")
    rng = np.random.default_rng(ref)
    u, lam = rng.standard_normal(R.n), rng.standard_normal(R.m)
    host = HostAugmentedSystem(p)
    for a, b in zip(host.apply(u, lam),
                    R.apply(torch.tensor(u), torch.tensor(lam))):
        assert _rel(a, b.numpy()) < 1e-13
    own = [1.0] + [0.0] * (len(modes) - 1)                     # file's data
    for a, b in zip(host.rhs(), R.rhs(own)):
        assert _rel(a, b.numpy()) < 1e-13
    assert R.gamma == pytest.approx(host.gamma, rel=1e-14)


def test_laplace_port_solve_judged_converged():
    cfg, modes = _config("laplace_circle", 6, 6), _modes("laplace_modes")
    cfg["precision"] = "float64"
    drv = immersed_laplace.Driver(cfg, "cpu")
    drv.setup()
    drv.prepare(modes)
    R = LaplaceReference(cfg["problem"], modes, "cpu")
    w = np.array([0.48, -0.6, 0.64])
    drv.set_data(w)
    (u, lam), rec = drv.solve()
    assert rec["ok"]
    res, thr = R.judge((u, lam), w)
    assert res <= thr
    assert abs(res - rec["reported_residual"]) < 1e-9 * thr


@pytest.mark.parametrize("pair", [(4, 5), (5, 6)])
def test_stokes_reference_is_the_ports_system(pair):
    cfg, modes = _config("stokes2d_circle", *pair), _modes("stokes_modes")
    from fictitious_domain_al_preconditioners_torch.models import \
        StokesProblem

    p = StokesProblem(stokes.config_of(cfg["problem"]), device="cpu").setup()
    R = StokesReference(cfg["problem"], modes, "cpu")
    rng = np.random.default_rng(pair[0])
    x = [rng.standard_normal(k) for k in p.layout.sizes]
    host = HostStokesSystem(p)
    for a, b in zip(host.apply(*x), R.apply(*[torch.tensor(v) for v in x])):
        assert _rel(a, b.numpy()) < 1e-13
    for a, b in zip(host.rhs(), R.rhs([1.0] + [0.0] * (len(modes) - 1))):
        assert _rel(a, b.numpy()) < 1e-13 or np.abs(a).max() == 0


def test_stokes_mode_loads_as_the_port_assembles_them():
    cfg, modes = _config("stokes2d_circle", 4, 5), _modes("stokes_modes")
    drv = stokes.Driver(cfg, "cpu")
    drv.setup()
    drv.prepare(modes)
    R = StokesReference(cfg["problem"], modes, "cpu")
    assert _rel(drv.f_modes.numpy(), R.f_modes.numpy()) < 1e-13
    assert _rel(drv.g_modes.numpy(), R.g_modes.numpy()) < 1e-13
