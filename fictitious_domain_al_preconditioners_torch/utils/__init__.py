"""Expression parsing, the setup state carried from the reference, and the
guarded iterative-refinement loop."""

from .expressions import ParsedFunction, compile_expression, parse_constants
from .carry import CarriedState, DiagonalMatrix, state_from_jax
from .refine import CORRECTION_MAX_OUTER, guarded_refinement

__all__ = ["ParsedFunction", "compile_expression", "parse_constants",
           "CarriedState", "DiagonalMatrix", "state_from_jax",
           "CORRECTION_MAX_OUTER", "guarded_refinement"]
