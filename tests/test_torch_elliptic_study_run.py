"""The port's whole convergence study through ``run()`` (three cycles,
background refinement 3 to 5, the immersed ball at 2 to 4): counts near the
reference's goldens, the L2 error falling at a rate above 0.8, the rates in
the table; each cycle's count and errors are held to the JAX package's in
``test_torch_elliptic_study.py`` and ``test_torch_elliptic_study_c1.py``
(cycles 0 and 1; cycle 2 alone takes JAX over a minute to compile)."""

import numpy as np
import torch

from fictitious_domain_al_preconditioners_torch.models import (
    EllipticInterfaceConfig as TConfig, EllipticInterfaceProblem as TProblem)

from test_torch_elliptic import base_config, inject_lanczos
from test_torch_elliptic_study import GOLDEN_STUDY, STUDY

torch.set_num_threads(1)


def test_convergence_study_run():
    prob = inject_lanczos(TProblem(base_config(TConfig, **STUDY),
                                   device="cpu"))
    table = prob.run()
    its = [row["outer_iterations"] for row in table.rows]
    assert all(abs(g - i) <= 2 for g, i in zip(GOLDEN_STUDY, its)), its
    l2 = [row["L2"] for row in table.rows]
    h1 = [row["H1"] for row in table.rows]
    assert l2[0] > l2[1] > l2[2], l2
    assert h1[0] > h1[1] > h1[2], h1
    rate = np.log2(l2[-2] / l2[-1])
    assert rate > 0.8, (l2, rate)
    assert float(table.rows[-1]["L2.rate"]) == round(rate, 2)
    assert all(row["constraint_residual"] < 1e-6 for row in table.rows)
    assert "L2.rate" in table.render()


def test_float32_v_cycles_keep_the_float64_count():
    """chip_smoke.py's configuration (β₂ = 1e3, W = M²) at cycle 1: with the
    V-cycles in float32 (the card's precision) the float64 Krylov solvers
    take the float64 solve's outer count, and the refined solve reaches
    1e-10 in the same steps."""
    import chip_smoke as S

    runs = {}
    for dt in (torch.float64, torch.float32):
        prob = TProblem(S.elliptic_config(), device="cpu", dtype=dt)
        its = prob.setup(1).solve()
        assert prob.results["converged"] and prob.u.dtype == torch.float64
        _, _, _, hist = prob.solve_refined(tol_abs=1e-10)
        runs[dt] = (its, prob.results["refine_steps"], hist[-1])
    assert runs[torch.float32][:2] == runs[torch.float64][:2]
    assert max(r[2] for r in runs.values()) <= 1e-10
