"""``stokes_immersed_boundary`` (2D) through the port's normal entry:
``StokesProblem(cfg, device=…).setup()``, then ``solve()`` with the
request's load vectors set on the problem's public ``rhs_u`` and
``rhs_g``."""

from __future__ import annotations

import math

import torch

from ..reference.stokes import StokesReference

DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: the control (``fdal_bench.control``): the program with its operator and
#: Krylov solvers in float32, the precision below the float64 they run in
CONTROL = "driver"


def config_of(problem: dict):
    from fictitious_domain_al_preconditioners_torch.models.stokes import (
        ALControl, OuterControl, StokesConfig)

    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in problem.items() if k not in ("al", "outer")}
    return StokesConfig(al=ALControl(**problem["al"]),
                        outer=OuterControl(**problem["outer"]), **kw)


def problem_class(operator_dtype=None):
    """The port's ``StokesProblem``, or with ``operator_dtype`` the same
    program with its operator and Krylov precision (the class's
    ``OP_DTYPE``) set to it: the control's path."""
    from fictitious_domain_al_preconditioners_torch.models import \
        StokesProblem

    if operator_dtype is None:
        return StokesProblem
    return type("StokesProblemLowered", (StokesProblem,),
                {"OP_DTYPE": operator_dtype})


class Driver:
    """One problem of the configuration on ``device``; ``precision`` is the
    V-cycle's (the operator and every Krylov solver run in float64, the
    port's ``StokesProblem.OP_DTYPE``)."""

    reference_class = StokesReference

    def __init__(self, config: dict, device, operator_dtype=None):
        self.config = config
        self.problem_spec = config["problem"]
        self.prob = problem_class(operator_dtype)(
            config_of(self.problem_spec), device=device,
            dtype=DTYPES[config["precision"]])

    def setup(self):
        self.prob.setup()
        return self.prob.results["setup_seconds"]

    def prepare(self, modes: list):
        """The traffic's mode loads by the port's own functions at the
        orders ``setup()`` uses, component-major, on the device in the
        operator's dtype: (n_modes, 2·n_u) and (n_modes, 2·m)."""
        from fictitious_domain_al_preconditioners_torch.ops.assembly import (
            imm_rhs, rhs_vector)
        from fictitious_domain_al_preconditioners_torch.utils.expressions \
            import ParsedFunction

        p = self.prob
        kw = dict(device=p.device, dtype=p.OP_DTYPE)
        self.f_modes = torch.stack([
            rhs_vector(p.vel_space, ParsedFunction(*md["f"]),
                       order=p.cfg.velocity_degree + 2, **kw).T.reshape(-1)
            for md in modes])
        self.g_modes = torch.stack([
            imm_rhs(p.mult_space, ParsedFunction(*md["g"]),
                    order=p._coupling_order(), **kw).T.reshape(-1)
            for md in modes])

    def set_data(self, weights):
        c = torch.as_tensor(weights, dtype=self.f_modes.dtype,
                            device=self.f_modes.device)
        self.prob.rhs_u = c @ self.f_modes
        self.prob.rhs_g = c @ self.g_modes

    def solve(self):
        p = self.prob
        u, pr, lam, info = p.solve()
        r = p.results
        reported = float(info.residual)
        ok = bool(r["converged"]) and math.isfinite(reported)
        return (u, pr, lam), dict(
            ok=ok, reported_residual=reported,
            outer_iterations=r["outer_iterations"],
            host_syncs=r["host_syncs"])

    def build_seconds(self) -> float:
        return self.prob.results.get("build_seconds", 0.0)


def control_driver(config: dict, device):
    return Driver(config, device, operator_dtype=torch.float32)
