"""The elliptic interface problem of the PyTorch port against the JAX
package, in float64 on the CPU: the modified AL with the default W = M²
(goldens 9 and 10 at cycles 0 and 1), the host float64 residual of the 3x3
system, ``from_prm`` and the entry points.  The setup state is carried
across by ``state_from_jax`` with the Lanczos start vectors of both GMG
hierarchies injected."""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models import (
    EllipticInterfaceConfig as JConfig, EllipticInterfaceProblem as JProblem)
from fictitious_domain_al_preconditioners_tpu.ops.host_ref import \
    HostEllipticSystem as JHost
from fictitious_domain_al_preconditioners_torch.models import (
    EllipticInterfaceConfig as TConfig, EllipticInterfaceProblem as TProblem)
from fictitious_domain_al_preconditioners_torch.ops.host_ref import \
    HostEllipticSystem as THost
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# TestModifiedAL.test_iteration_flatness, tests/test_elliptic_interface.py
GOLDEN_DEFAULT = {0: 9, 1: 10}


def base_config(cls, **kw):
    """tests/test_elliptic_interface.py::base_config for either package."""
    cfg = dict(initial_background_refinement=4, initial_immersed_refinement=2,
               beta_2=10.0, use_modified_AL_preconditioner=True,
               gamma_AL_background=10.0, gamma_AL_immersed=1e-2,
               use_fixed_iterations=True, n_refinement_cycles=2)
    cfg.update(kw)
    return cls(**cfg)


def jax_normal(n):
    """The reference's Lanczos start vector of an n-dof level,
    ``jax.random.normal(PRNGKey(0), (n,))`` (``ops/krylov.py:188-191``)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                        dtype=jnp.float64))


def inject_lanczos(tp):
    """Give both of the port problem's hierarchies the reference's start
    vectors (they depend on the level's size only)."""
    tp.lanczos_start = tp.lanczos_start_a22 = lambda i, n: jax_normal(n)
    return tp


def level_sizes(sp):
    """Dofs of every GMG level of a lattice space, fine first."""
    sizes = []
    while True:
        sizes.append(sp.n_dofs)
        if any(n % 2 for n in sp.grid.ncells) or min(sp.grid.ncells) < 8:
            return sizes
        sp = sp.coarse_space()


def carried_arrays(jp):
    """The reference problem's setup state after ``setup()``, with the
    Lanczos start vectors of the A11 hierarchy and of A22's (its GMG levels
    on the lattice twin, else the one vector of its Chebyshev)."""
    C = jp.C
    a22 = (level_sizes(jp.fg_gridspace) if jp.fg_gridspace is not None
           else [jp.fg_space.n_dofs])
    return dict(
        rhs_f1=np.asarray(jp.rhs_f1), rhs_f2=np.asarray(jp.rhs_f2),
        bc_values=np.asarray(jp.bc_values), free=np.asarray(jp.free),
        bg_dofs=np.asarray(C.bg_dofs), bg_phi=np.asarray(C.bg_phi),
        imm_dofs=np.asarray(C.imm_dofs), imm_psi=np.asarray(C.imm_psi),
        jxw=np.asarray(C.jxw), a1_cell_dofs=np.asarray(jp.A1.row_dofs),
        a1_local=np.asarray(jp.A1.local),
        imm_cell_dofs=np.asarray(jp.M.row_dofs),
        a2_local=np.asarray(jp.A2.local), m_local=np.asarray(jp.M.local),
        lanczos_starts=[jax_normal(n) for n in level_sizes(jp.space)],
        lanczos_starts_a22=[jax_normal(n) for n in a22])


def block_solution(prob):
    return np.concatenate([np.asarray(x) for x in (prob.u, prob.u2,
                                                    prob.lam)])


def solve_pair(cycle=0, jp=None, **kw):
    """One configuration solved by both packages (float64, CPU), the port on
    the reference's carried setup state (``jp``: an already solved
    reference problem): ``(jax_problem, port_problem, jax_iterations,
    port_iterations, rel_diff)`` with ``rel_diff`` the max-norm difference
    of the block solutions relative to the reference's."""
    if jp is None:
        jp = JProblem(base_config(JConfig, **kw))
        jp.setup(cycle)
        jp.solve()
    tp = TProblem(base_config(TConfig, **kw), device="cpu").setup(cycle)
    tp.load_state(state_from_jax(carried_arrays(jp), "cpu", torch.float64))
    it = tp.solve()
    xj, xt = block_solution(jp), block_solution(tp)
    return (jp, tp, jp.results["outer_iterations"], it,
            float(np.abs(xt - xj).max() / np.abs(xj).max()))


# every configuration of the solve parity tests: (cycle, options, the
# reference's golden count from tests/test_elliptic_interface.py or None);
# each runs in a file of its own (one JAX compile of 25-45 s apiece): the
# suite runs under pytest-xdist's ``--dist loadfile``, which hands a worker
# a file, not a case, so cases of one parametrize would run in turn
VARIANTS = {
    "default_cycle0": (0, {}, GOLDEN_DEFAULT[0]),
    "default_cycle1": (1, {}, GOLDEN_DEFAULT[1]),
    "diagonal": (0, dict(use_diagonal_inverse=True), 14),
    "h_scaled": (0, dict(use_h_scaled_mass=True), None),
    "operator_form": (0, dict(use_operator_form=True), None),
    "ideal": (0, dict(use_modified_AL_preconditioner=False,
                      gamma_AL_immersed=10.0, use_fixed_iterations=False), 6),
}


def check_variant(name):
    """Solve configuration ``name`` of :data:`VARIANTS` in both packages:
    equal outer counts (the golden one where there is one), solutions equal
    to 1e-8, the same constraint residual.  Returns the reference
    problem."""
    cycle, kw, golden = VARIANTS[name]
    jp, tp, ij, it, rel = solve_pair(cycle, **kw)
    if golden is not None:
        assert ij == golden
    assert it == ij and tp.results["converged"]
    assert rel <= 1e-8
    assert tp.results["host_syncs"] > it
    assert tp.results["dofs_background"] == jp.space.n_dofs
    assert tp.results["dofs_immersed"] == jp.fg_space.n_dofs
    # the constraint residual ||C u - M u2||∞ of the reference
    assert tp.constraint_residual() == pytest.approx(
        jp.constraint_residual(), rel=1e-6, abs=1e-13)
    return jp


@pytest.fixture(scope="module")
def reference_default():
    return {}


def test_modified_default_w_matches_reference(reference_default):
    reference_default[0] = check_variant("default_cycle0")


def test_own_setup_matches_reference(reference_default):
    """The port's own setup (grids, matrices, coupling, right-hand sides)
    at cycle 0 gives the reference's count and solution with only the
    Lanczos vectors injected; so does its CCᵀ condition estimate."""
    jp = reference_default.get(0)
    if jp is None:
        jp = JProblem(base_config(JConfig))
        jp.setup(0)
        jp.solve()
    tp = inject_lanczos(TProblem(base_config(TConfig), device="cpu"))
    it = tp.setup(0).solve()
    assert it == jp.results["outer_iterations"] == GOLDEN_DEFAULT[0]
    xj, xt = block_solution(jp), block_solution(tp)
    assert np.abs(xt - xj).max() <= 1e-8 * np.abs(xj).max()
    assert tp.cct_condition_estimate() == pytest.approx(
        jp.cct_condition_estimate(), rel=1e-8)


HOST_VARIANTS = {
    "default": {}, "diagonal": dict(use_diagonal_inverse=True),
    "h_scaled": dict(use_h_scaled_mass=True),
    "h_scaled_diagonal": dict(use_h_scaled_mass=True,
                              use_diagonal_inverse=True),
    "operator_form": dict(use_operator_form=True),
    "convergence_study": dict(do_convergence_study=True,
                              initial_background_refinement=3),
}


@pytest.mark.parametrize("variant", sorted(HOST_VARIANTS))
def test_host_system_matches_reference(variant):
    """HostEllipticSystem's float64 residual equals the JAX package's on the
    same random iterate, for all four W variants, the operator form and the
    off-lattice immersed ball (element form, nested host CG)."""
    kw = HOST_VARIANTS[variant]
    jp = JProblem(base_config(JConfig, **kw))
    jp.setup(0)
    tp = TProblem(base_config(TConfig, **kw), device="cpu").setup(0)
    tp.load_state(state_from_jax(carried_arrays(jp), "cpu", torch.float64))
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(n) for n in tp.layout.sizes]
    rj = np.concatenate(JHost(jp).residual(*xs))
    rt = np.concatenate(THost(tp).residual(*xs))
    assert np.abs(rt - rj).max() <= 1e-12 * np.abs(rj).max()
    bj = np.concatenate(JHost(jp).rhs())
    bt = np.concatenate(THost(tp).rhs())
    assert np.abs(bt - bj).max() <= 1e-12 * np.abs(bj).max()


def test_from_prm_matches_reference():
    path = os.path.join(ROOT, "parameters", "elliptic_interface_modified.prm")
    tc, jc = TConfig.from_prm(path), JConfig.from_prm(path)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.use_modified_AL_preconditioner and tc.beta_2 == 1e3
    assert tc.gamma_AL_immersed == 1e-2 and tc.use_fixed_iterations
    assert tc.iteration_number.max_steps == 30
    assert tc.arguments_for_immersed_grid.startswith("-0.14")
    with open(path) as fh:
        assert dataclasses.asdict(TConfig.from_prm(fh.read())) == \
            dataclasses.asdict(jc)


def test_entry_points_default_to_the_card():
    """The problem and its new setup functions run on CUDA unless asked
    for the CPU; without a card, setup raises instead of falling back."""
    from fictitious_domain_al_preconditioners_torch.ops import assembly
    from fictitious_domain_al_preconditioners_torch.ops.sparse_band import \
        lattice_band_linop
    from fictitious_domain_al_preconditioners_torch.precond.weights import \
        lattice_mass_inverse

    for fn in (TProblem.__init__, assembly.mass_matrix,
               assembly.laplace_matrix, lattice_band_linop,
               lattice_mass_inverse):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    prob = TProblem(base_config(TConfig))
    assert prob.device.type == "cuda" and prob.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            prob.setup(0)


@pytest.mark.parametrize("kw", [dict(background_space_degree=2),
                                dict(immersed_space_degree=2)])
def test_unported_option_raises(kw):
    """A degree-2 background or immersed space raised "not ported yet"
    before the port took it: it now sets up, and the Q2 side's V-cycle is
    the flat hierarchy in element form while the Q1 side keeps the
    lattice (the parity against the reference is
    tests/test_torch_degree2.py)."""
    prob = TProblem(base_config(TConfig, **kw), device="cpu").setup(0)
    parts = prob._solver_parts()
    for gmg, sp in ((parts["gmg11"], prob.space),
                    (parts["gmg22"], prob.fg_gridspace)):
        assert gmg.levels[0].space is sp
        flat = sp.fe.degree == 2
        assert gmg.levels[0].mask.dim() == (1 if flat else 2)
