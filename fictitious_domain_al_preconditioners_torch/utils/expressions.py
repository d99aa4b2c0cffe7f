"""muparser-compatible expression evaluator (NumPy backend).

The reference drives all user-facing functions (right-hand sides, boundary
conditions, immersed-geometry parametrizations) through muparser strings
configured in ``.prm`` files.  This module parses such a string once into an
AST and evaluates it with NumPy on the host.  Torch tensors are accepted and
returned on their own device: they are evaluated through NumPy on the host
(every call site is setup-time).

Supported surface (superset of what the reference's configs use):
  - arithmetic ``+ - * / ^`` (``^`` is power, right associative, as in
    muparser)
  - comparisons ``< > <= >= == !=`` and logical ``&& || !``
  - ``if(cond, a, b)`` (``where``, branch-free)
  - functions: sin cos tan asin acos atan atan2 sinh cosh tanh exp log ln
    log2 log10 sqrt abs pow min max floor ceil sign exp2 hypot mod
  - constants ``pi``/``Pi``/``e``, user constants (``R=.2, Cx=.4`` syntax)
  - multiple components separated by ``;`` (vector-valued functions)
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["ParsedFunction", "compile_expression", "parse_constants"]

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><=|>=|==|!=|&&|\|\||[-+*/^(),<>!])"
    r")"
)


def _tokenize(src: str):
    pos, out = 0, []
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            if src[pos:].strip() == "":
                break
            raise ValueError(f"cannot tokenize expression at: {src[pos:]!r}")
        pos = m.end()
        if m.group("num") is not None:
            out.append(("num", float(m.group("num"))))
        elif m.group("name") is not None:
            out.append(("name", m.group("name")))
        else:
            out.append(("op", m.group("op")))
    out.append(("end", None))
    return out


# --- AST -------------------------------------------------------------------
# Nodes are plain tuples: ("num", v) | ("var", i) | ("call", fn, [args]) |
# ("bin", op, a, b) | ("neg", a) | ("not", a)

def _make_tables(xp):
    funcs_1 = {
        "sin": xp.sin, "cos": xp.cos, "tan": xp.tan,
        "asin": xp.arcsin, "acos": xp.arccos, "atan": xp.arctan,
        "sinh": xp.sinh, "cosh": xp.cosh, "tanh": xp.tanh,
        "exp": xp.exp, "log": xp.log, "ln": xp.log,
        "log2": xp.log2, "log10": xp.log10, "exp2": xp.exp2,
        "sqrt": xp.sqrt, "abs": xp.abs, "floor": xp.floor,
        "ceil": xp.ceil, "sign": xp.sign, "int": xp.trunc,
    }
    funcs_2 = {
        "atan2": xp.arctan2, "pow": xp.power, "hypot": xp.hypot,
        "mod": xp.mod, "fmod": xp.mod,
    }
    funcs_n = {"min": xp.minimum, "max": xp.maximum}
    bin_ops = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "*": lambda a, b: a * b,
        "/": lambda a, b: a / b,
        "^": xp.power,
        "<": lambda a, b: a < b,
        ">": lambda a, b: a > b,
        "<=": lambda a, b: a <= b,
        ">=": lambda a, b: a >= b,
        "==": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
        "&&": xp.logical_and,
        "||": xp.logical_or,
    }
    return funcs_1, funcs_2, funcs_n, bin_ops, xp


_NP_TABLES = _make_tables(np)


class _Parser:
    def __init__(self, tokens, var_index, constants):
        self.toks = tokens
        self.i = 0
        self.var_index = var_index
        self.constants = constants

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_op(self, op):
        kind, val = self.next()
        if kind != "op" or val != op:
            raise ValueError(f"expected {op!r}, got {val!r}")

    def parse(self):
        node = self.or_expr()
        if self.peek()[0] != "end":
            raise ValueError(f"trailing tokens: {self.toks[self.i:]}")
        return node

    def or_expr(self):
        node = self.and_expr()
        while self.peek() == ("op", "||"):
            self.next()
            node = ("bin", "||", node, self.and_expr())
        return node

    def and_expr(self):
        node = self.cmp_expr()
        while self.peek() == ("op", "&&"):
            self.next()
            node = ("bin", "&&", node, self.cmp_expr())
        return node

    def cmp_expr(self):
        node = self.add_expr()
        kind, val = self.peek()
        if kind == "op" and val in ("<", ">", "<=", ">=", "==", "!="):
            self.next()
            node = ("bin", val, node, self.add_expr())
        return node

    def add_expr(self):
        node = self.mul_expr()
        while True:
            kind, val = self.peek()
            if kind == "op" and val in ("+", "-"):
                self.next()
                node = ("bin", val, node, self.mul_expr())
            else:
                return node

    def mul_expr(self):
        node = self.unary_expr()
        while True:
            kind, val = self.peek()
            if kind == "op" and val in ("*", "/"):
                self.next()
                node = ("bin", val, node, self.unary_expr())
            else:
                return node

    def unary_expr(self):
        kind, val = self.peek()
        if kind == "op" and val in ("-", "+", "!"):
            self.next()
            inner = self.unary_expr()
            if val == "-":
                return ("neg", inner)
            if val == "!":
                return ("not", inner)
            return inner
        return self.pow_expr()

    def pow_expr(self):
        base = self.atom()
        if self.peek() == ("op", "^"):
            self.next()
            return ("bin", "^", base, self.unary_expr())  # right associative
        return base

    def atom(self):
        kind, val = self.next()
        if kind == "num":
            return ("num", val)
        if kind == "op" and val == "(":
            node = self.or_expr()
            self.expect_op(")")
            return node
        if kind == "name":
            if self.peek() == ("op", "("):
                self.next()
                args = [self.or_expr()]
                while self.peek() == ("op", ","):
                    self.next()
                    args.append(self.or_expr())
                self.expect_op(")")
                return ("call", val, args)
            if val in ("pi", "Pi", "PI"):
                return ("num", math.pi)
            if val in ("e", "E"):
                return ("num", math.e)
            if val in self.constants:
                return ("num", float(self.constants[val]))
            if val in self.var_index:
                return ("var", self.var_index[val])
            raise ValueError(f"unknown identifier {val!r}")
        raise ValueError(f"unexpected token {val!r}")


def _eval_ast(node, vals, tables):
    funcs_1, funcs_2, funcs_n, bin_ops, xp = tables
    tag = node[0]
    if tag == "num":
        return node[1]
    if tag == "var":
        return vals[node[1]]
    if tag == "neg":
        return -_eval_ast(node[1], vals, tables)
    if tag == "not":
        return xp.logical_not(_eval_ast(node[1], vals, tables))
    if tag == "bin":
        _, op, a, b = node
        return bin_ops[op](_eval_ast(a, vals, tables),
                           _eval_ast(b, vals, tables))
    if tag == "call":
        _, name, args = node
        evald = [_eval_ast(a, vals, tables) for a in args]
        if name == "if":
            if len(evald) != 3:
                raise ValueError("if() takes exactly 3 arguments")
            return xp.where(evald[0], evald[1], evald[2])
        if name in funcs_1:
            (a,) = evald
            return funcs_1[name](a)
        if name in funcs_2:
            a, b = evald
            return funcs_2[name](a, b)
        if name in funcs_n:
            out = evald[0]
            for v in evald[1:]:
                out = funcs_n[name](out, v)
            return out
        raise ValueError(f"unknown function {name!r}")
    raise AssertionError(node)


def parse_constants(spec: str) -> dict:
    """Parse ``"R=.2, Cx=.4, Cy=.4"`` into a dict of floats."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        out[name.strip()] = float(val.strip())
    return out


def compile_expression(expr: str, variables: Sequence[str], constants: dict | None = None) -> Callable:
    """Compile a single scalar expression into ``f(*vals) -> ndarray``
    (NumPy inputs)."""
    var_index = {v.strip(): i for i, v in enumerate(variables)}
    ast = _Parser(_tokenize(expr), var_index, constants or {}).parse()

    def fn(*vals):
        return _eval_ast(ast, vals, _NP_TABLES)

    return fn


@dataclass
class ParsedFunction:
    """Drop-in for deal.II ``Functions::ParsedFunction``.

    ``expression`` is one or more muparser expressions separated by ``;``
    (one per component).  ``constants`` uses the ``.prm`` syntax
    ``"R=.2, Cx=.4"``.  Calling evaluates all components at an ``(N, dim)``
    array of points (plus scalar time ``t``) and returns ``(N,)`` for scalar
    functions or ``(N, n_components)`` otherwise.  A torch tensor of points
    gives a tensor on the same device and dtype.
    """

    expression: str
    constants: str = ""
    variables: str = "x,y,t"

    def __post_init__(self):
        names = [v.strip() for v in self.variables.split(",") if v.strip()]
        consts = parse_constants(self.constants)
        self._names = names
        self._fns = [
            compile_expression(comp.strip(), names, consts)
            for comp in self.expression.split(";")
            if comp.strip() != ""
        ]

    @property
    def n_components(self) -> int:
        return len(self._fns)

    def __call__(self, points, t: float = 0.0):
        if isinstance(points, torch.Tensor):
            out = np.array(self(points.detach().cpu().numpy(), t))
            return torch.as_tensor(out, dtype=points.dtype,
                                   device=points.device)
        points = np.atleast_2d(np.asarray(points))
        n, dim = points.shape
        vals = []
        for i, name in enumerate(self._names):
            if name == "t":
                vals.append(np.full((n,), t, dtype=points.dtype))
            elif i < dim:
                vals.append(points[:, i])
            else:
                vals.append(np.zeros((n,), dtype=points.dtype))
        comps = [np.broadcast_to(np.asarray(f(*vals), dtype=points.dtype), (n,))
                 for f in self._fns]
        if len(comps) == 1:
            return comps[0]
        return np.stack(comps, axis=-1)
