"""The elasticity interface problem's 2D variant (``tests/test_elasticity.py
::test_2d_variant``, golden 17) in both packages, at its stopping rule and
to a reduction of 1e-9: see ``test_torch_elasticity.py``.  The iterates
agree as far as the stopping rule lets them (5e-5 of their max at the
golden's reduction of 1e-6, 2e-7 at 1e-9)."""

import pytest
import torch

from test_torch_elasticity import GOLDEN, check_solve

torch.set_num_threads(1)


def variant_2d(mod):
    cfg = mod.ElasticityInterfaceConfig(
        dim=2, arguments_for_background_grid="-1.25: 1.25: true",
        name_of_immersed_grid="hyper_rectangle",
        arguments_for_immersed_grid="-0.65, -0.3: 0.65, 0.3: false",
        dirichlet_ids=(0, 1, 2, 3), initial_background_refinement=3,
        initial_immersed_refinement=2, use_fixed_iterations=True)
    cfg.outer.tolerance = 1e-9
    return cfg


@pytest.mark.parametrize("reduction, golden, rel",
                         [(1e-6, GOLDEN["2d"], 2e-4), (1e-9, 27, 1e-6)])
def test_2d_matches_reference(reduction, golden, rel):
    def cfg_kw(mod):
        cfg = variant_2d(mod)
        cfg.outer.reduction = reduction
        return cfg

    tp = check_solve(cfg_kw, golden, rel=rel)
    assert tp.results["dofs_background"] == 2 * 9 ** 2
    assert tp.results["dofs_immersed"] == 2 * 5 ** 2
    assert tp.results["gmg_routes"] == {"a11": ["band", "band"],
                                        "a22": ["band"]}
