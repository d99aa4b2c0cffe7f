"""Expression parsing and the setup state carried from the reference."""

from .expressions import ParsedFunction, compile_expression, parse_constants
from .carry import CarriedState, DiagonalMatrix, state_from_jax

__all__ = ["ParsedFunction", "compile_expression", "parse_constants",
           "CarriedState", "DiagonalMatrix", "state_from_jax"]
