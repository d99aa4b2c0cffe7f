"""The configuration files' function expressions (the parameter files'
muparser syntax: ``;`` between components, ``^`` for powers, constants as
``"R=.2, Cx=.4"``), evaluated with NumPy or torch.  Expressions come from
the benchmark's own files, never from outside."""

from __future__ import annotations

import math

import numpy as np

_NAMES = ("sin", "cos", "tan", "exp", "log", "sqrt", "abs", "tanh")


def constants(text: str) -> dict:
    out = {}
    for item in text.split(","):
        if item.strip():
            key, val = item.split("=")
            out[key.strip()] = float(val)
    return out


def evaluate(expression: str, consts: str, points):
    """Each component of ``expression`` at ``points``: an (N, 2) array (the
    result an (N,) array, or (N, k) for k components) or a pair ``(X, Y)``
    of torch tensors (a tensor, or a list of k)."""
    if isinstance(points, tuple):
        import torch

        x, y = points
        lib = {name: getattr(torch, name) for name in _NAMES}
        pair = True
    else:
        x, y = points[:, 0], points[:, 1]
        lib = {name: getattr(np, name) for name in _NAMES}
        pair = False
    scope = {"__builtins__": {}, "pi": math.pi, "x": x, "y": y, "t": 0.0,
             **lib, **constants(consts)}
    comps = [eval(c.strip().replace("^", "**"), scope)
             for c in expression.split(";") if c.strip()]
    if pair:
        return comps[0] if len(comps) == 1 else comps
    comps = [np.broadcast_to(np.asarray(c, dtype=np.float64), x.shape)
             for c in comps]
    return comps[0] if len(comps) == 1 else np.stack(comps, axis=1)
