"""The least time each of the port's kernel entries needs for one call,
from the call's shape, dtype and mode: a frozen copy of the byte and
operation counts of ``chip_smoke.py`` (``bound``, ``fused_bound`` and the
K1/K6 counts beside them), with the published peaks of one NVIDIA H100 SXM
(data sheet, dense, without sparsity)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
# operations of one 9-point tensor-product stencil apply per point: 3
# column sums (1 add) each feeding two 3-term factors (2 mul + 1 add each),
# then 6 mul + 3 add in the row combination
STENCIL_FLOPS = 30
ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}


def bound_s(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S):
    """Bytes over the memory rate against operations over the rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)


def stencil_bound_s(shape, dtype: str) -> float:
    """K1 (``masked_laplace_2d``) or K6 (``laplace_stencil_2d``): the lattice
    read once and written once, one stencil apply a point; bf16 storage
    computes in float32."""
    n = shape[0] * shape[1]
    rate = F64_FLOP_PER_S if dtype == "float64" else F32_FLOP_PER_S
    return bound_s(2 * ITEMSIZE[dtype] * n, STENCIL_FLOPS * n, rate)


def fused_bound_s(mode: str, shape, box, degree: int) -> float:
    """K2 (``fused_augmented_2d``): the lattice inputs read once (b, and x0
    in post), the outputs written once (x, and r in pre), the 5 patch
    planes read once; the stencil applications, Chebyshev updates and
    patch terms done (float32)."""
    n = shape[0] * shape[1]
    area = box[2] * box[3]
    arrays = {"op": 2, "smooth": 2, "pre": 3, "post": 3}[mode]
    apps = {"op": 1, "smooth": degree - 1, "pre": degree,
            "post": degree}[mode]
    updates = 0 if mode == "op" else degree - 1
    nbytes = 4 * (arrays * n + 5 * area)
    flops = n * (apps * STENCIL_FLOPS + 6 * updates + 4) + area * apps * 18
    return bound_s(nbytes, flops)


def call_bound_s(call: dict) -> float:
    """The bound of one recorded call (see ``trace.KernelCalls``)."""
    if call["kernel"] == "fused_augmented_2d":
        return fused_bound_s(call["mode"], call["shape"], call["box"],
                             call["degree"])
    return stencil_bound_s(call["shape"], call["dtype"])
