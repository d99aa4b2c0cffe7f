"""immersed_laplace with a DG0 (``embedded_space_degree = 0``) and a Q2
(``= 2``) multiplier, and the bf16 V-cycle on the element-form path, in the
PyTorch port against the JAX package solving in the test, float64 on the
CPU.  Each package sets up on its own; the port gets the JAX package's
Lanczos start vectors (``jax.random.normal(PRNGKey(0), (n,))`` of every GMG
level, in float32 for the bf16 hierarchy).

- The lattice path (K1 and K2 on the card) at refinement 5 in the
  flagship's configuration (``bench.py:48-62``): the operator form with
  W = diag(M) and W = M, the explicit form with W = diag(M)², through
  ``run()``.
- The element-form path at 3 + 1 (one local refinement step, embedded 4).
- The bf16 V-cycle on the element-form path at 3 + 1, degree 1, to a
  tight tolerance (the bf16 cycles of the two packages round differently;
  at the flagship's 3e-5 the iterates agree only to the stop).

Outer counts are equal, u and λ within 1e-8 of the reference's max.  Also:
the particle planes of the operator form depend on the Γ quadrature only
(bit-equal for every multiplier degree), and ``cct_condition_estimate``
equals the reference's to rel 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models.immersed_laplace import (
    ImmersedLaplaceConfig as JConfig, ImmersedLaplaceProblem as JProblem,
    SolverControlConfig as JControl)
from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
    import (ImmersedLaplaceConfig as TConfig,
            ImmersedLaplaceProblem as TProblem,
            SolverControlConfig as TControl)

torch.set_num_threads(1)

SOL_TOL = 1e-8
CIRCLE = ("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy", "R=.2, Cx=.4, Cy=.4")
DEGREES = {"dg0": 0, "q2": 2}
# (use_operator_form, use_diagonal_inverse)
FORMS = {"diag_w": (True, True), "exact_w": (True, False),
         "explicit": (False, True)}
# 3 + 1: the background one step finer near Γ; embedded 4 keeps h_Γ below
# the finest cell's diameter
ELEMENT_FORM = dict(initial_refinement=3, delta_refinement=1,
                    initial_embedded_refinement=4)


def flagship(cfg_cls, control_cls, *, refinement=5, kdeg=1, form="diag_w",
             tight=False, **kw):
    """``bench.py``'s flagship configuration (smooth data, the augmented
    solver, its float32 rule 3e-5 / 1e-6, or 1e-10 / 1e-12 with
    ``tight``) with multiplier degree ``kdeg`` in AL form ``form``."""
    op, diag = FORMS[form]
    tol, red = (1e-10, 1e-12) if tight else (3e-5, 1e-6)
    cfg = dict(initial_refinement=refinement,
               initial_embedded_refinement=refinement,
               embedded_configuration=CIRCLE,
               embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
               embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
               solver="augmented", use_operator_form=op,
               use_diagonal_inverse=diag, embedded_space_degree=kdeg,
               schur=control_cls(max_steps=400, tolerance=tol,
                                 reduction=red))
    cfg.update(kw)
    return cfg_cls(**cfg)


def jax_normal(n, dtype=jnp.float64):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                        dtype=dtype))


def port_problem(cfg, bf16=False):
    tp = TProblem(cfg, device="cpu")
    dt = jnp.float32 if bf16 else jnp.float64
    tp.lanczos_start = lambda i, n: jax_normal(n, dt)
    return tp


def check_pair(jp, tp):
    """Equal outer counts, both converged, u and λ within 1e-8 of the
    reference's max, the same spaces."""
    assert tp.results["converged"] and jp.results["converged"]
    assert tp.results["outer_iterations"] == jp.results["outer_iterations"]
    assert tp.space.n_dofs == jp.space.n_dofs
    assert tp.imm_space.n_dofs == jp.imm_space.n_dofs
    for a, b in ((tp.u, jp.u), (tp.lam, jp.lam)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= SOL_TOL * np.abs(b).max()


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("degree", sorted(DEGREES))
def test_lattice_path_matches_reference(degree, form):
    kdeg = DEGREES[degree]
    jp = JProblem(flagship(JConfig, JControl, kdeg=kdeg, form=form))
    jp.run()
    tp = port_problem(flagship(TConfig, TControl, kdeg=kdeg, form=form))
    results = tp.run()
    assert results is tp.results and not tp.element_form
    check_pair(jp, tp)
    assert tp.imm_space.n_dofs == (32 if kdeg == 0 else 65)
    # the operator form's fine level carries K2's patch planes
    assert (tp.level_stencils[0] is not None) == FORMS[form][0]
    assert tp.constraint_residual() < 1e-4


@pytest.mark.parametrize("degree", sorted(DEGREES))
def test_element_form_matches_reference(degree):
    kdeg = DEGREES[degree]
    jp = JProblem(flagship(JConfig, JControl, kdeg=kdeg, **ELEMENT_FORM))
    jp.setup()
    jp.solve()
    tp = port_problem(flagship(TConfig, TControl, kdeg=kdeg,
                               **ELEMENT_FORM)).setup()
    tp.solve()
    assert tp.element_form and tp.space.n_constrained_cells > 0
    check_pair(jp, tp)


def test_bf16_element_form_matches_reference():
    """The bf16 V-cycle on the element-form path: every level operator, the
    smoother and the transfers take and return bf16; the count and the
    tight-tolerance solution equal the reference's."""
    kw = dict(ELEMENT_FORM, use_bf16_multigrid=True, tight=True)
    jp = JProblem(flagship(JConfig, JControl, **kw))
    jp.setup()
    jp.solve()
    tp = port_problem(flagship(TConfig, TControl, **kw), bf16=True).setup()
    tp.solve()
    assert tp.element_form and tp._last_gmg.dtype == torch.bfloat16
    check_pair(jp, tp)
    for level in tp._last_gmg.levels:
        x = torch.ones(level.mask.numel(), dtype=torch.bfloat16)
        assert level.op(x).dtype == torch.bfloat16
        assert level.smoother(x).dtype == torch.bfloat16
        if level.prolong is not None:       # from this level to the finer
            n_fine, _ = level.prolong.shape
            assert level.prolong.mv(x).dtype == torch.bfloat16
            assert level.prolong.rmv(torch.ones(
                n_fine, dtype=torch.bfloat16)).dtype == torch.bfloat16


def test_planes_do_not_depend_on_the_multiplier():
    """The particle AL term γ/h_Γ·Σ_q φφᵀ JxW of the operator form uses the
    background basis and the Γ quadrature only: the 9-point patch planes of
    a DG0 and a Q2 multiplier are bit-equal to degree 1's, at every GMG
    level of the flagship's lattice path."""
    probs = {k: TProblem(flagship(TConfig, TControl, refinement=6, kdeg=k),
                         device="cpu").setup() for k in (0, 1, 2)}
    gamma, _, _, _, _ = probs[1]._al_form()
    sp, patched = probs[1].space, 0
    while True:
        planes = {}
        for k, prob in probs.items():
            assert prob.curve.h_max == probs[1].curve.h_max
            coupling = prob._al_form()[3](sp)
            planes[k] = coupling.patch_w9(sp, gamma)
        if planes[1] is None:         # a coarse band touching ∂Ω
            assert planes[0] is None and planes[2] is None
        else:
            patched += 1
            for k in (0, 2):
                assert planes[k][0] == planes[1][0]
                assert np.array_equal(planes[k][1], planes[1][1])
        if min(sp.grid.ncells) // 2 < 4:
            break
        sp = sp.coarse_space()
    assert patched >= 2


@pytest.mark.parametrize("degree", sorted(DEGREES))
def test_cct_condition_estimate_matches_reference(degree):
    """cond(CCᵀ) from CG's tridiagonal, with enough steps for CG to
    converge: the Q2 multiplier's CCᵀ (condition about 1e5) takes 183 CG
    steps at refinement 5, and an estimate cut at the default 100 depends
    on the rounding of the unconverged recurrence (the two packages
    differed by 1.6e-5 there)."""
    kdeg = DEGREES[degree]
    jp = JProblem(flagship(JConfig, JControl, kdeg=kdeg)).setup()
    tp = TProblem(flagship(TConfig, TControl, kdeg=kdeg),
                  device="cpu").setup()
    ref = jp.cct_condition_estimate(max_steps=400)
    assert ref > 1.0
    assert tp.cct_condition_estimate(max_steps=400) == pytest.approx(
        ref, rel=1e-8)
