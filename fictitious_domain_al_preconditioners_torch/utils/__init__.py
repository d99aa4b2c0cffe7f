"""Expression parsing, the setup state carried from the reference, the
guarded iterative-refinement loop, the prm reader, convergence tables and
phase timers."""

from .expressions import ParsedFunction, compile_expression, parse_constants
from .carry import CarriedState, DiagonalMatrix, EllipticState, state_from_jax
from .refine import CORRECTION_MAX_OUTER, guarded_refinement
from .prm import Params, dump_prm, parse_prm
from .report import ConvergenceTable
from .timer import TimerOutput

__all__ = ["ParsedFunction", "compile_expression", "parse_constants",
           "CarriedState", "DiagonalMatrix", "EllipticState", "state_from_jax",
           "CORRECTION_MAX_OUTER", "guarded_refinement", "Params",
           "dump_prm", "parse_prm", "ConvergenceTable", "TimerOutput"]
