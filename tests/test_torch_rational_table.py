"""The results table's rational rows at refinements 7-9 in both packages on
the CPU, each on its own setup: f = 0, g = 1 on the circle, the rational
preconditioner, tolerance 3e-5 and reduction 1e-6
(scripts/make_results_table.py:127-146), in float64 (MinRes) and in float32
(FGMRES, the precision of the TPU's table and of the port on the card).

The TPU's float32 rows took 37, 55 and 37 outer iterations
(tables/results_tpu.md:44-46).  ``COUNTS`` holds the JAX package's own
counts on the CPU; the port takes the same in float64 and within one in
float32, where the two packages round differently."""

import jax
import pytest
import torch

from test_torch_immersed_laplace import (CIRCLE, JConfig, JProblem, TConfig,
                                         TProblem)

torch.set_num_threads(1)

# outer iterations of the JAX package on the CPU under the table's rule
COUNTS = {("float64", 7): 18, ("float64", 8): 18, ("float64", 9): 14,
          ("float32", 7): 10, ("float32", 8): 10, ("float32", 9): 10}


def table_config(cfg_cls, ref):
    cfg = cfg_cls(initial_refinement=ref, initial_embedded_refinement=ref,
                  embedded_configuration=CIRCLE, embedding_rhs=("0", ""),
                  embedded_value=("1", ""), solver="rational")
    cfg.schur.tolerance, cfg.schur.reduction = 3e-5, 1e-6
    return cfg


def check_row(ref, precision):
    with jax.enable_x64(precision == "float64"):
        jp = JProblem(table_config(JConfig, ref))
        jp.setup()
        _, _, ij = jp.solve()
        j_its, j_conv = int(ij.iterations), bool(ij.converged)
    tp = TProblem(table_config(TConfig, ref), device="cpu",
                  dtype=getattr(torch, precision)).setup()
    _, _, it = tp.solve()
    assert j_conv and it.converged
    assert j_its == COUNTS[(precision, ref)]
    assert abs(it.iterations - j_its) <= (0 if precision == "float64" else 1)


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_rational_table_row_7(precision):
    check_row(7, precision)
