"""Linear operators: callables on tensors with a known shape and an optional
transpose.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.linop``
(deal.II's ``LinearOperator`` layer), reduced to what the flagship path uses; the
operator algebra (``A + B``, ``A @ B``, ...) comes with the families that
compose operators.
"""

from __future__ import annotations

__all__ = ["LinOp", "diag_op"]


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


def diag_op(d) -> LinOp:
    n = d.shape[0]
    return LinOp(lambda x: d * x, (n, n), lambda x: d * x, name="diag")
