"""The flagship AL solve of the PyTorch port end to end against the JAX
package, in float64 on the CPU, with the setup state carried across by
``state_from_jax`` and the GMG Lanczos start vectors injected."""

import inspect

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


def carried_arrays(jp, matrices=False):
    """The reference problem's setup state, with the Lanczos start vector
    ``jax.random.normal(PRNGKey(0), (n,))`` of every GMG level; with
    ``matrices`` also the immersed mass and stiffness matrices."""
    sizes, sp = [], jp.space
    while True:
        sizes.append(sp.n_dofs)
        if any(n % 2 for n in sp.grid.ncells) or min(sp.grid.ncells) < 8:
            break
        sp = sp.coarse_space()
    C = jp.C
    arrays = dict(
        rhs_f=np.asarray(jp.rhs_f), rhs_g=np.asarray(jp.rhs_g),
        bc_values=np.asarray(jp.bc_values), free=np.asarray(jp.free),
        bg_dofs=np.asarray(C.bg_dofs), bg_phi=np.asarray(C.bg_phi),
        imm_dofs=np.asarray(C.imm_dofs), imm_psi=np.asarray(C.imm_psi),
        jxw=np.asarray(C.jxw), m_diag=np.asarray(jp.M.diag()),
        lanczos_starts=[np.asarray(jax.random.normal(
            jax.random.PRNGKey(0), (n,), dtype=jnp.float64)) for n in sizes])
    if matrices:
        arrays.update(imm_cell_dofs=np.asarray(jp.M.row_dofs),
                      m_local=np.asarray(jp.M.local),
                      a_local=np.asarray(jp.A_imm.local))
    return arrays


def mode_config(cfg_cls, control_cls, solver, ref):
    """The configurations of the whole-mode parity tests: ``rational`` and
    ``ELMAN_triang`` as tests/test_baseline_tables.py pins them (f = 0,
    g = 1), ``CG`` as tests/test_immersed_laplace.py::TestOtherSolvers runs
    it (smooth data, default controls)."""
    if solver == "CG":
        return cfg_cls(
            initial_refinement=ref, initial_embedded_refinement=ref,
            embedded_configuration=CIRCLE,
            embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
            embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""), solver="CG")
    schur = (control_cls(max_steps=400, tolerance=1e-8, reduction=1e-8)
             if solver == "ELMAN_triang" else
             control_cls(max_steps=1000, tolerance=1e-10, reduction=1e-12))
    return cfg_cls(initial_refinement=ref, initial_embedded_refinement=ref,
                   embedded_configuration=CIRCLE, embedding_rhs=("0", ""),
                   embedded_value=("1", ""), solver=solver, schur=schur)


def solve_pair(solver, ref):
    """One mode solved by both packages (float64, CPU), the port on the
    reference's carried setup state: ``(jax_info, port_info, rel_diff)``
    with ``rel_diff`` the max-norm difference of the solutions relative to
    the reference's."""
    jp = JProblem(mode_config(JConfig, JControl, solver, ref)).setup()
    uj, _, ij = jp.solve()
    tp = TProblem(mode_config(TConfig, TControl, solver, ref),
                  device="cpu").setup()
    tp.load_state(state_from_jax(carried_arrays(jp, matrices=True), "cpu",
                                 torch.float64))
    ut, _, it = tp.solve()
    assert tp.results["host_syncs"] > it.iterations
    uj = np.asarray(uj)
    return ij, it, float(np.abs(ut.numpy() - uj).max() / np.abs(uj).max())


@pytest.mark.parametrize("ref", sorted(GOLDEN_DIAG))
def test_flagship_matches_reference(ref):
    jp = JProblem(golden_config(JConfig, JControl, ref))
    jp.setup()
    uj, _, ij = jp.solve()
    tp = TProblem(golden_config(TConfig, TControl, ref), device="cpu").setup()
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
    prob = TProblem(cfg, device="cpu").setup()
    u, _, info = prob.solve()
    assert info.converged and info.iterations < 60
    err = l2_error(prob.space, u, lambda p: np.sin(2 * np.pi * p[:, 0])
                   * np.sin(2 * np.pi * p[:, 1]))
    assert err < 6e-3
    assert prob.constraint_residual() < 1e-6


def test_unported_options_raise():
    """``delta_refinement`` sets up on the element-form path, with the
    bf16 V-cycle too, and a DG0 or Q2 multiplier sets up on the lattice
    path (they raised "not ported yet" before the port took them); what is
    still unported raises: ``solve_refined`` on the element form (the host
    float64 reference applies the lattice stiffness only, as the reference
    package's does)."""
    cfg = golden_config(TConfig, TControl, 4)
    cfg.delta_refinement = 1
    cfg.initial_embedded_refinement = 6
    prob = TProblem(cfg, device="cpu").setup()
    assert prob.element_form and prob.grid.max_level == 5
    with pytest.raises(NotImplementedError, match="uniform Q1 lattice"):
        prob.solve_refined()
    cfg.use_bf16_multigrid = True
    assert TProblem(cfg, device="cpu").setup().element_form
    for kdeg, n_imm in ((0, 16), (2, 33)):
        other = golden_config(TConfig, TControl, 4)
        other.embedded_space_degree = kdeg
        prob = TProblem(other, device="cpu").setup()
        assert not prob.element_form
        assert prob.imm_space.n_dofs == n_imm
        assert prob.imm_space.fe.continuous == (kdeg > 0)


def test_entry_points_default_to_the_card():
    """The problem and the public builders run on CUDA unless the caller
    asks for the CPU; without a card, setup raises instead of falling back
    to the CPU."""
    from fictitious_domain_al_preconditioners_torch.ops import assembly
    from fictitious_domain_al_preconditioners_torch.ops.coupling import \
        build_coupling

    builders = [build_coupling, assembly.rhs_vector, assembly.imm_mass_matrix,
                assembly.imm_stiffness_matrix, assembly.imm_rhs,
                assembly.interpolate]
    for fn in builders + [TProblem.__init__]:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg = golden_config(TConfig, TControl, 4)
    prob = TProblem(cfg)
    assert prob.device.type == "cuda" and prob.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            prob.setup()
