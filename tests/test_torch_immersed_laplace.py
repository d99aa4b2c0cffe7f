"""The flagship AL solve of the PyTorch port end to end against the JAX
package, in float64 on the CPU, with the setup state carried across by
``state_from_jax`` and the GMG Lanczos start vectors injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models import (
    ImmersedLaplaceConfig as JConfig, ImmersedLaplaceProblem as JProblem)
from fictitious_domain_al_preconditioners_tpu.models.immersed_laplace import \
    SolverControlConfig as JControl
from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceConfig as TConfig, ImmersedLaplaceProblem as TProblem)
from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
    import SolverControlConfig as TControl
from fictitious_domain_al_preconditioners_torch.ops.assembly import l2_error
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax

torch.set_num_threads(1)

# TestALFlat.GOLDEN_DIAG, tests/test_baseline_tables.py:69
GOLDEN_DIAG = {4: 20, 5: 28, 6: 28}
CIRCLE = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")


def golden_config(cfg_cls, control_cls, ref):
    """The configuration of tests/test_baseline_tables.py::config for the
    augmented solver with W = diag(M)."""
    return cfg_cls(
        initial_refinement=ref, initial_embedded_refinement=ref,
        embedded_configuration=CIRCLE, embedding_rhs=("0", ""),
        embedded_value=("1", ""), solver="augmented",
        use_operator_form=True, use_diagonal_inverse=True,
        schur=control_cls(max_steps=1000, tolerance=1e-10, reduction=1e-12))


def carried_arrays(jp):
    """The reference problem's setup state, with the Lanczos start vector
    ``jax.random.normal(PRNGKey(0), (n,))`` of every GMG level."""
    sizes, sp = [], jp.space
    while True:
        sizes.append(sp.n_dofs)
        if any(n % 2 for n in sp.grid.ncells) or min(sp.grid.ncells) < 8:
            break
        sp = sp.coarse_space()
    C = jp.C
    return dict(
        rhs_f=np.asarray(jp.rhs_f), rhs_g=np.asarray(jp.rhs_g),
        bc_values=np.asarray(jp.bc_values), free=np.asarray(jp.free),
        bg_dofs=np.asarray(C.bg_dofs), bg_phi=np.asarray(C.bg_phi),
        imm_dofs=np.asarray(C.imm_dofs), imm_psi=np.asarray(C.imm_psi),
        jxw=np.asarray(C.jxw), m_diag=np.asarray(jp.M.diag()),
        lanczos_starts=[np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (n,), dtype=jnp.float64)) for n in sizes])


@pytest.mark.parametrize("ref", sorted(GOLDEN_DIAG))
def test_flagship_matches_reference(ref):
    jp = JProblem(golden_config(JConfig, JControl, ref))
    jp.setup()
    uj, _, ij = jp.solve()
    tp = TProblem(golden_config(TConfig, TControl, ref)).setup()
    tp.load_state(state_from_jax(carried_arrays(jp), "cpu", torch.float64))
    ut, _, it = tp.solve()
    assert int(ij.iterations) == GOLDEN_DIAG[ref]
    assert it.converged and it.iterations == int(ij.iterations)
    uj = np.asarray(uj)
    assert np.abs(ut.numpy() - uj).max() <= 1e-8 * np.abs(uj).max()
    assert tp.results["host_syncs"] > it.iterations


def test_smooth_solution_accuracy():
    """tests/test_immersed_laplace.py::TestAugmented::test_operator_form on
    the port: u = sin(2πx) sin(2πy) is exact, so the L2 error is the
    discretization error."""
    cfg = TConfig(initial_refinement=5, initial_embedded_refinement=5,
                  embedded_configuration=CIRCLE,
                  embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
                  embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
                  solver="augmented", use_operator_form=True,
                  use_diagonal_inverse=True)
    prob = TProblem(cfg).setup()
    u, _, info = prob.solve()
    assert info.converged and info.iterations < 60
    err = l2_error(prob.space, u, lambda p: np.sin(2 * np.pi * p[:, 0])
                   * np.sin(2 * np.pi * p[:, 1]))
    assert err < 6e-3
    assert prob.constraint_residual() < 1e-6


def test_unported_options_raise():
    cfg = golden_config(TConfig, TControl, 4)
    cfg.solver = "CG"
    with pytest.raises(NotImplementedError, match="not ported"):
        TProblem(cfg).setup()
