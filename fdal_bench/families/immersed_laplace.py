"""``immersed_laplace`` through the port's normal entry:
``ImmersedLaplaceProblem(cfg, device=…).setup()``, then ``solve()`` with
the request's load vectors set on the problem's public ``rhs_f`` and
``rhs_g``."""

from __future__ import annotations

import math

import torch

from ..reference.laplace import LaplaceReference

DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: the lattice path runs the port's CUDA kernels: build them first, apart
USES_KERNELS = True


def config_of(problem: dict):
    from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
        import ImmersedLaplaceConfig, SolverControlConfig

    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in problem.items() if k != "schur"}
    return ImmersedLaplaceConfig(schur=SolverControlConfig(**problem["schur"]),
                                 **kw)


class Driver:
    """One problem of the configuration on ``device``, in the working dtype
    the configuration states."""

    reference_class = LaplaceReference

    def __init__(self, config: dict, device):
        from fictitious_domain_al_preconditioners_torch.models import \
            ImmersedLaplaceProblem

        self.config = config
        self.problem_spec = config["problem"]
        self.prob = ImmersedLaplaceProblem(
            config_of(self.problem_spec), device=device,
            dtype=DTYPES[config["precision"]])

    def setup(self):
        self.prob.setup()
        return self.prob.results["setup_seconds"]

    def prepare(self, modes: list):
        """The load vectors of the traffic's modes, assembled by the port's
        own functions at the orders ``setup()`` uses, kept on the device
        in the working dtype: (n_modes, n) and (n_modes, m).  A mode whose
        data is the configuration's own takes the vectors ``setup()``
        assembled."""
        from fictitious_domain_al_preconditioners_torch.ops.assembly import (
            imm_rhs, rhs_vector)
        from fictitious_domain_al_preconditioners_torch.utils.expressions \
            import ParsedFunction

        p, cfg = self.prob, self.prob.cfg
        kw = dict(device=p.device, dtype=p.dtype)
        own = (list(cfg.embedding_rhs), list(cfg.embedded_value))
        f, g = [], []
        for md in modes:
            if (md["f"], md["g"]) == own:
                f.append(p.rhs_f)
                g.append(p.rhs_g)
                continue
            f.append(rhs_vector(p.space, ParsedFunction(*md["f"]),
                                order=cfg.embedding_space_degree + 1, **kw))
            g.append(imm_rhs(p.imm_space, ParsedFunction(*md["g"]),
                             order=max(cfg.embedded_space_degree + 1, 2),
                             **kw))
        self.f_modes, self.g_modes = torch.stack(f), torch.stack(g)

    def set_data(self, weights):
        c = torch.as_tensor(weights, dtype=self.f_modes.dtype,
                            device=self.f_modes.device)
        self.prob.rhs_f = c @ self.f_modes
        self.prob.rhs_g = c @ self.g_modes

    def solve(self):
        """One request: ``(answer, record)``; the answer the device tensors
        (u, λ), the record the solve's counters from ``results``."""
        p = self.prob
        u, lam, info = p.solve()
        r = p.results
        reported = float(info.residual)
        ok = bool(r["converged"]) and math.isfinite(reported)
        return (u, lam), dict(
            ok=ok, reported_residual=reported,
            outer_iterations=r["outer_iterations"],
            host_syncs=r["host_syncs"])

    def build_seconds(self) -> float:
        return self.prob.results.get("build_seconds", 0.0)


#: the control (``fdal_bench.control``): the program's answer carried in the
#: precision below the one the configuration states
CONTROL = "answer"


def lower_precision(answer):
    """The control's answer: the answer carried in bfloat16, the precision
    below the float32 that the configuration states (the best answer any
    bfloat16 computation can return)."""
    return tuple(torch.as_tensor(a).to(torch.bfloat16).float() for a in answer)
