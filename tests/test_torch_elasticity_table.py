"""The elasticity interface problem in the results table's configuration
(``scripts/make_results_table.py:222-246``: fixed inner iterations, W = M²
exact) at cycle 0 with the tests' tolerance 1e-9 (golden 23,
``tests/test_elasticity.py``) in both packages: see
``test_torch_elasticity.py``."""

import torch

from test_torch_elasticity import GOLDEN, check_solve, table

torch.set_num_threads(1)


def test_table_cycle0_matches_reference():
    tp = check_solve(table, GOLDEN["table0"])
    assert tp.results["dofs_background"] == 3 * 9 ** 3
    assert tp.results["dofs_immersed"] == 3 * 5 ** 3
    assert len(tp._last_parts["gmg11"].levels) == 2
    assert len(tp.results["gmg_routes"]["a11"]) == 2
