"""Linear operators: callables on tensors with a known shape and an optional
transpose, and their algebra.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.linop``
(deal.II's ``LinearOperator`` layer, reference usage e.g.
immersed_laplace.cc:511-519, elliptic_interface.cc:816-819): ``A + B``,
``A - B``, ``alpha * A``, ``-A`` and ``A @ B`` (composition) build new
operators, as the reference's preconditioners are written.
"""

from __future__ import annotations

import torch

__all__ = ["LinOp", "identity", "zero_op", "diag_op"]


class LinOp:
    """A linear map ``y = A @ x`` as a callable with a known shape.

    ``rmv`` (optional) is the transpose action, enabling ``.T``."""

    def __init__(self, mv, shape, rmv=None, name: str = ""):
        self._mv = mv
        self._rmv = rmv
        self.shape = tuple(shape)
        self.name = name

    def __call__(self, x):
        return self._mv(x)

    @property
    def T(self) -> "LinOp":
        if self._rmv is None:
            raise ValueError(f"operator {self.name!r} has no transpose action")
        return LinOp(self._rmv, (self.shape[1], self.shape[0]), self._mv,
                     name=f"{self.name}^T")

    def __add__(self, other: "LinOp") -> "LinOp":
        assert self.shape == other.shape, (self.shape, other.shape)
        rmv = None
        if self._rmv is not None and other._rmv is not None:
            def rmv(x):
                return self._rmv(x) + other._rmv(x)
        return LinOp(lambda x: self(x) + other(x), self.shape, rmv)

    def __sub__(self, other: "LinOp") -> "LinOp":
        return self + (-1.0) * other

    def __neg__(self) -> "LinOp":
        return (-1.0) * self

    def __rmul__(self, alpha) -> "LinOp":
        rmv = None if self._rmv is None else (lambda x: alpha * self._rmv(x))
        return LinOp(lambda x: alpha * self(x), self.shape, rmv)

    def __matmul__(self, other: "LinOp") -> "LinOp":
        assert self.shape[1] == other.shape[0], (self.shape, other.shape)
        rmv = None
        if self._rmv is not None and other._rmv is not None:
            def rmv(x):
                return other._rmv(self._rmv(x))
        return LinOp(lambda x: self(other(x)),
                     (self.shape[0], other.shape[1]), rmv)


def identity(n: int) -> LinOp:
    return LinOp(lambda x: x, (n, n), lambda x: x, name="I")


def zero_op(m: int, n: int) -> LinOp:
    def mv(x):
        return torch.zeros((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)

    def rmv(x):
        return torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)

    return LinOp(mv, (m, n), rmv, name="0")


def diag_op(d) -> LinOp:
    n = d.shape[0]
    return LinOp(lambda x: d * x, (n, n), lambda x: d * x, name="diag")
