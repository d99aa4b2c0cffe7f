"""The port's CUDA kernels on the card: each wrapper against its plain
version (K1 in float32 and bf16), the wrappers' checks, and small solves of
every mode, and of the flagship with the bf16 V-cycle, against the CPU.
Marked ``gpu``; without a card every test skips.  On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_torch.models import (
    ImmersedLaplaceConfig, ImmersedLaplaceProblem)
from fictitious_domain_al_preconditioners_torch.ops import kernels as K

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _stencil(device, shape=(97, 161), box=(20, 30, 40, 50), seed=0):
    rng = np.random.default_rng(seed)
    planes = rng.uniform(0.1, 1.0, (5,) + box[2:]).astype(np.float32)
    h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    return K.AugmentedStencil2D(h, shape, torch.as_tensor(planes,
                                                          device=device), box)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("box", [(20, 30, 40, 50), (0, 0, 97, 161)])
def test_kernels_match_plain(cuda, box):
    st = _stencil(cuda, box=box)
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                        device=cuda)
    x0 = torch.as_tensor(rng.standard_normal(st.shape), dtype=torch.float32,
                         device=cuda)
    before = dict(K.LAUNCHES)
    assert _rel(K.masked_laplace_2d(b, st.h),
                K.masked_laplace_2d_plain(b, st.h)) <= 1e-6
    tol = {"op": 1e-6, "smooth": 2e-5, "pre": 2e-5, "post": 5e-5}
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        got = K.fused_augmented_2d(mode, st, b, xin, lam_max=1.5)
        ref = K.fused_augmented_2d_plain(mode, st, b, xin, lam_max=1.5)
        if mode == "pre":
            assert _rel(got[0], ref[0]) <= tol[mode]
            assert _rel(got[1], ref[1]) <= 5e-5
        else:
            assert _rel(got, ref) <= tol[mode]
    assert K.LAUNCHES["masked_laplace_2d"] == before["masked_laplace_2d"] + 1
    for mode in K.MODES:
        key = f"fused_augmented_2d:{mode}"
        assert K.LAUNCHES[key] == before[key] + 1


@pytest.mark.parametrize("shape", [(97, 161), (1025, 1025)])
def test_k6_and_no_patch_k2_match_plain(cuda, shape):
    h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    st = K.AugmentedStencil2D(h, shape, device=cuda, dtype=torch.float32)
    rng = np.random.default_rng(2)
    b = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=cuda)
    x0 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=cuda)
    before = dict(K.LAUNCHES)
    assert _rel(K.laplace_stencil_2d(b, h),
                K.laplace_stencil_2d_plain(b, h)) <= 1e-6
    tol = {"op": 1e-6, "smooth": 2e-5, "pre": 2e-5, "post": 5e-5}
    for mode in K.MODES:
        xin = x0 if mode == "post" else None
        got = K.fused_augmented_2d(mode, st, b, xin, lam_max=1.5)
        ref = K.fused_augmented_2d_plain(mode, st, b, xin, lam_max=1.5)
        pairs = zip(got, ref) if mode == "pre" else [(got, ref)]
        for g, r in pairs:
            assert _rel(g, r) <= tol[mode]
    assert K.LAUNCHES["laplace_stencil_2d"] == \
        before["laplace_stencil_2d"] + 1
    for mode in K.MODES:
        key = K.launch_key(mode, patch=False)
        assert K.LAUNCHES[key] == before[key] + 1


@pytest.mark.parametrize("shape", [(65, 65), (1025, 1025), (530, 777)])
def test_k1_bf16_matches_plain(cuda, shape):
    """K1's bf16-storage form against its plain version (float32 arithmetic,
    one rounding): a float32 sum order can flip one bf16 rounding, one ulp
    (2^-8) of the value, so the bound is 1e-2 of max |plain|."""
    h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(shape),
                        dtype=torch.float32, device=cuda).to(torch.bfloat16)
    before = dict(K.LAUNCHES)
    got = K.masked_laplace_2d(u, h)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert _rel(got.float(), K.masked_laplace_2d_plain(u, h).float()) <= 1e-2
    assert K.LAUNCHES["masked_laplace_2d:bf16"] == \
        before["masked_laplace_2d:bf16"] + 1
    assert K.LAUNCHES["masked_laplace_2d"] == before["masked_laplace_2d"]


def test_wrappers_check_their_inputs(cuda):
    st = _stencil(cuda)
    with pytest.raises(TypeError):
        K.masked_laplace_2d(torch.zeros(st.shape, dtype=torch.float64,
                                        device=cuda), st.h)
    with pytest.raises(TypeError):
        K.masked_laplace_2d(torch.zeros(st.shape, dtype=torch.float16,
                                        device=cuda), st.h)
    with pytest.raises(ValueError):
        K.fused_augmented_2d("op", st, torch.zeros((5, 5), device=cuda))
    with pytest.raises(ValueError):
        K.fused_augmented_2d("smooth", st, torch.zeros(st.shape,
                                                       device=cuda).T)


def test_small_flagship_matches_cpu(cuda):
    def cfg():
        c = ImmersedLaplaceConfig(
            initial_refinement=6, initial_embedded_refinement=6,
            embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                    "R=.2, Cx=.4, Cy=.4"),
            embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
            embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
            solver="augmented", use_operator_form=True,
            use_diagonal_inverse=True)
        c.schur.tolerance, c.schur.reduction = 3e-5, 1e-6
        return c

    ug, _, ig = ImmersedLaplaceProblem(cfg(), device=cuda).setup().solve()
    uc, _, ic = ImmersedLaplaceProblem(cfg(), device="cpu",
                                        dtype=torch.float32).setup().solve()
    assert ig.converged and abs(ig.iterations - ic.iterations) <= 1
    assert float((ug.cpu() - uc).abs().max()) <= 1e-3 * float(uc.abs().max())


def test_bf16_flagship_matches_cpu(cuda):
    """The flagship with the bf16 V-cycle at refinement 7, float32 outer:
    the card (K1 bf16 on every level) against the CPU (plain versions)."""
    def cfg():
        c = ImmersedLaplaceConfig(
            initial_refinement=7, initial_embedded_refinement=7,
            embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                    "R=.2, Cx=.4, Cy=.4"),
            embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
            embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
            solver="augmented", use_operator_form=True,
            use_diagonal_inverse=True, use_bf16_multigrid=True)
        c.schur.tolerance, c.schur.reduction = 3e-5, 1e-6
        return c

    K.reset_launch_counts()
    ug, _, ig = ImmersedLaplaceProblem(cfg(), device=cuda).setup().solve()
    launches = dict(K.LAUNCHES)
    uc, _, ic = ImmersedLaplaceProblem(cfg(), device="cpu",
                                        dtype=torch.float32).setup().solve()
    assert ig.converged and abs(ig.iterations - ic.iterations) <= 1
    assert float((ug.cpu() - uc).abs().max()) <= 1e-3 * float(uc.abs().max())
    assert launches["masked_laplace_2d:bf16"] > 0
    assert launches[K.launch_key("op")] > 0
    assert launches[K.launch_key("pre")] == 0


@pytest.mark.parametrize("solver", ["CG", "ELMAN_triang", "rational"])
def test_small_modes_match_cpu(cuda, solver):
    """The f = 0, g = 1 circle at refinement 5 with the flagship's float32
    stopping rule: the card (kernels) against the CPU (plain versions)."""
    def cfg():
        c = ImmersedLaplaceConfig(
            initial_refinement=5, initial_embedded_refinement=5,
            embedded_configuration=("R*cos(2*pi*x)+Cx; R*sin(2*pi*x)+Cy",
                                    "R=.2, Cx=.4, Cy=.4"),
            solver=solver)
        c.schur.tolerance, c.schur.reduction = 3e-5, 1e-6
        return c

    K.reset_launch_counts()
    ug, _, ig = ImmersedLaplaceProblem(cfg(), device=cuda).setup().solve()
    launches = dict(K.LAUNCHES)
    uc, _, ic = ImmersedLaplaceProblem(cfg(), device="cpu",
                                       dtype=torch.float32).setup().solve()
    assert ig.converged and abs(ig.iterations - ic.iterations) <= 1
    assert float((ug.cpu() - uc).abs().max()) <= 1e-3 * float(uc.abs().max())
    for key in ("masked_laplace_2d", "laplace_stencil_2d",
                K.launch_key("pre", False), K.launch_key("post", False)):
        assert launches[key] > 0, key
