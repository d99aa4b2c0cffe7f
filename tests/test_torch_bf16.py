"""The bfloat16 V-cycle of the PyTorch port against the JAX package: K1's
bf16-storage form (plain version) against the reference's two bf16 forms,
and one V-cycle of the bf16 hierarchy, with the reference's setup state and
its float32 Lanczos start vectors carried across.  The whole bf16 flagship
solve is in tests/test_torch_bf16_flagship.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models import (
    ImmersedLaplaceConfig as JConfig, ImmersedLaplaceProblem as JProblem)
from fictitious_domain_al_preconditioners_tpu.models.immersed_laplace import \
    SolverControlConfig as JControl
from fictitious_domain_al_preconditioners_tpu.ops.pallas_kernels import (
    _masked_conv9_xla, masked_laplace_2d as jax_masked_laplace_2d,
    stencil_factors_2d)
from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceConfig as TConfig, ImmersedLaplaceProblem as TProblem)
from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
    import SolverControlConfig as TControl
from fictitious_domain_al_preconditioners_torch.ops import kernels as K
from fictitious_domain_al_preconditioners_torch.precond.chebyshev import \
    chebyshev
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax
from test_torch_immersed_laplace import carried_arrays, golden_config

torch.set_num_threads(1)

BF16 = torch.bfloat16
SHAPES = [(65, 65), (129, 129), (33, 47)]


def _field(shape, seed):
    """A random lattice field, rounded to bf16 (values exact in both)."""
    u = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(u, dtype=torch.float32).to(BF16)


def _h(shape):
    return (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))


def _jax_w(h):
    K0, M0, K1, M1 = stencil_factors_2d(h)
    return np.outer(K0, M1) + np.outer(M0, K1)


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_bf16_plain_matches_reference_f32_form(shape):
    """The TPU kernel's bf16 semantics: float32 arithmetic on the bf16
    input, one rounding.  The reference's float32 form on the same (bf16
    exact) input, rounded to bf16, differs only where a float32 sum order
    flips a bf16 rounding: at most one bf16 ulp (2^-8 relative) of the
    largest output, 8e-3."""
    u = _field(shape, seed=sum(shape))
    h = _h(shape)
    got = K.masked_laplace_2d_plain(u, h)
    assert got.dtype == BF16 and tuple(got.shape) == shape
    ref = _masked_conv9_xla(_jax_w(h), *shape, jnp.float32)(
        jnp.asarray(u.float().numpy()))
    ref = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 8e-3 * np.abs(ref).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_bf16_plain_matches_reference_bf16_form(shape):
    """Against the reference's own ``masked_laplace_2d(dtype=bfloat16)``,
    which off the TPU computes in bf16 arithmetic: its nine rounded partial
    sums of terms up to ~8/3 of |u| cost a few bf16 ulps of the largest
    output, so the bound is 3e-2 of max |ref|."""
    u = _field(shape, seed=7 + sum(shape))
    h = _h(shape)
    got = K.masked_laplace_2d_plain(u, h).float().numpy()
    ref = jax_masked_laplace_2d(h, shape, dtype=jnp.bfloat16)(
        jnp.asarray(u.float().numpy(), dtype=jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()


def bf16_config(cfg_cls, control_cls, ref):
    cfg = golden_config(cfg_cls, control_cls, ref)
    cfg.use_bf16_multigrid = True
    return cfg


def bf16_carried_arrays(jp):
    """The reference's setup state with the Lanczos start vectors of its
    bf16 hierarchy, drawn in float32 (``gmg.py:376-393``)."""
    arrays = carried_arrays(jp)
    arrays["lanczos_starts"] = [
        np.asarray(jax.random.normal(jax.random.PRNGKey(0), (len(v),),
                                     dtype=jnp.float32))
        for v in arrays["lanczos_starts"]]
    return arrays


def test_bf16_option_is_supported():
    """``use_bf16_multigrid`` sets up (it raised ``NotImplementedError``
    before this port); an option that is still unported still raises."""
    cfg = bf16_config(TConfig, TControl, 4)
    TProblem(cfg, device="cpu").setup()
    cfg.delta_refinement = 1
    with pytest.raises(NotImplementedError, match="delta_refinement"):
        TProblem(cfg, device="cpu").setup()


def test_coupling_and_transfers_keep_bf16():
    """The AL terms, ``CellMatrix.mv`` and the Q1 transfers return a bf16
    input in bf16 (torch would promote a float64 weight times a bf16 tensor
    to float64), and agree with their float64 applies to bf16 accuracy."""
    from fictitious_domain_al_preconditioners_torch.ops.operators import \
        CellMatrix
    from fictitious_domain_al_preconditioners_torch.parallel.lattice import (
        lattice_prolong, lattice_restrict)
    from test_torch_kernels import flagship_patch

    rng = np.random.default_rng(11)
    for ref in (2, 5):        # the band touches ∂Ω at 2, is interior at 5
        space, C, gamma = flagship_patch(ref)
        shape = tuple(reversed(space.n_points_1d))
        x = torch.as_tensor(rng.standard_normal(shape))
        al, _ = C.compact_al(gamma)
        pairs = [(al, x.reshape(-1))]
        lat = C.patch_al_lattice(space, gamma)
        assert (lat is None) == (ref == 2)
        if lat is not None:
            pairs.append((lat[0], x))
        # the same applies built in bf16, as a bf16 level builds them: the
        # weights are cast once, and give the same bits
        al16, _ = C.compact_al(gamma, dtype=BF16)
        built = [al16]
        if lat is not None:
            built.append(C.patch_al_lattice(space, gamma, dtype=BF16)[0])
        for (fn, v), fn16 in zip(pairs, built):
            got, ref64 = fn(v.to(BF16)), fn(v.to(BF16).double())
            assert got.dtype == BF16
            assert float((got.double() - ref64).abs().max()) \
                <= 2e-2 * float(ref64.abs().max())
            assert torch.equal(fn16(v.to(BF16)), got)
    local = rng.standard_normal((6, 2, 2))
    dofs = rng.integers(0, 5, (6, 2))
    M = CellMatrix(dofs, dofs, local, (5, 5), device="cpu",
                   dtype=torch.float64)
    assert M.mv(torch.ones(5, dtype=BF16)).dtype == BF16
    u = torch.as_tensor(rng.standard_normal((9, 17))).to(BF16)
    assert lattice_restrict(u).dtype == BF16
    assert lattice_prolong(u).dtype == BF16


def _recording(fn, seen, name):
    def wrapped(*args):
        out = fn(*args)
        seen.append((name, tuple(a.dtype for a in args), out.dtype))
        return out
    return wrapped


def test_one_vcycle_matches_reference_and_stays_bf16():
    """One application of the bf16 V-cycle (refinement 4, 3 levels) on the
    same random residual in both packages.  The two round at different
    places (the port's level operator rounds once per K1 apply, the
    reference's bf16 arithmetic at every partial sum), so they agree to the
    bf16 level, within 5e-2 of max |x|.  Every level operator, smoother,
    transfer and the coarse solve see and return bf16; the coarse inverse
    is float32."""
    ref = 4
    jp = JProblem(bf16_config(JConfig, JControl, ref))
    jp.setup()
    jp._augmented_run()
    jgmg = jp._last_gmg
    tp = TProblem(bf16_config(TConfig, TControl, ref), device="cpu").setup()
    tp.load_state(state_from_jax(bf16_carried_arrays(jp), "cpu",
                                 torch.float64))
    tp._augmented_run()
    gmg = tp._last_gmg
    assert gmg.dtype == BF16 and gmg.coarse_inv.dtype == torch.float32
    assert len(gmg.levels) == len(jgmg.levels)

    seen = []
    for i, lv in enumerate(gmg.levels):
        assert lv.diag_inv.dtype == BF16 and lv.mask.dtype == BF16
        lv.op = _recording(lv.op, seen, f"op{i}")
        lv.smoother = _recording(
            chebyshev(lv.op, lv.diag_inv, lv.lam_max,
                      degree=tp.cfg.gmg_smoother_degree), seen, f"smooth{i}")
        if lv.prolong is not None:
            lv.prolong.mv = _recording(lv.prolong.mv, seen, f"prolong{i}")
            lv.prolong.rmv = _recording(lv.prolong.rmv, seen, f"restrict{i}")
    gmg._coarse_solve = _recording(gmg._coarse_solve, seen, "coarse")

    shape = tuple(reversed(tp.space.n_points_1d))
    b = np.random.default_rng(3).standard_normal(shape)
    x = gmg.apply(torch.as_tensor(b))
    assert x.dtype == torch.float64
    assert seen and all(ins == (BF16,) * len(ins) and out == BF16
                        for _, ins, out in seen), seen
    names = {n for n, _, _ in seen}
    assert {"coarse", "op0", "smooth0", "restrict1", "prolong1"} <= names

    xj = np.asarray(jax.jit(jgmg.apply)(jnp.asarray(b)))
    assert xj.dtype == np.float64
    assert np.abs(x.numpy() - xj).max() <= 5e-2 * np.abs(xj).max()
