"""The whole flagship solve of the PyTorch port with ``use_bf16_multigrid``
(bfloat16 V-cycle, float64 outer, CPU) against the JAX package at
refinements 4-6, with the reference's setup state and the float32 Lanczos
start vectors of its bf16 hierarchy carried across."""

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
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax
from test_torch_bf16 import BF16, bf16_carried_arrays, bf16_config

torch.set_num_threads(1)

# outer counts of the reference's bf16 solve at refinements 4-6 (float64
# outer, CPU): the count the port is held to, +-1
JAX_BF16_COUNTS = {4: 21, 5: 28, 6: 29}


@pytest.mark.parametrize("ref", sorted(JAX_BF16_COUNTS))
def test_bf16_flagship_matches_reference(ref):
    jp = JProblem(bf16_config(JConfig, JControl, ref))
    jp.setup()
    uj, _, ij = jp.solve()
    uj = np.asarray(uj)
    assert abs(int(ij.iterations) - JAX_BF16_COUNTS[ref]) <= 1
    tp = TProblem(bf16_config(TConfig, TControl, ref), device="cpu").setup()
    tp.load_state(state_from_jax(bf16_carried_arrays(jp), "cpu",
                                 torch.float64))
    ut, _, it = tp.solve()
    assert tp._last_gmg.dtype == BF16 and ut.dtype == torch.float64
    assert it.converged and abs(it.iterations - int(ij.iterations)) <= 1
    assert np.abs(ut.numpy() - uj).max() <= 1e-6 * np.abs(uj).max()
