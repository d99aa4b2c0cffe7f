"""Krylov solvers with deal.II-style controls: CG, flexible GMRES (CGS2) and
a Lanczos largest-eigenvalue estimate.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.krylov``.  The
``lax.while_loop`` bodies become Python loops; each iteration reads its
residual norm on the host (one ``.item()``-style sync per CG or FGMRES step).
Callers that want those syncs counted pass a ``stats`` dict, whose
``"host_syncs"`` entry is incremented once per device-to-host read.

Control semantics (as in the reference):
  - ``tol``: absolute residual tolerance
  - ``reduction``: stop at ``max(tol, reduction * ||r0||)``
  - ``max_steps``: iteration cap
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["SolveInfo", "cg", "fgmres", "lanczos_max_eig"]


class SolveInfo(NamedTuple):
    iterations: int
    residual: float
    res0: float
    converged: bool


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _host(t, stats):
    """Read a device scalar (or small tensor) on the host: one sync."""
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1
    return t.tolist()


def _threshold(tol, reduction, res0):
    if reduction is not None:
        return max(tol, reduction * res0)
    return tol


def cg(A: Callable, b, M: Optional[Callable] = None, *, tol: float = 1e-10,
       reduction: float | None = None, max_steps: int = 100,
       stats: dict | None = None):
    """Preconditioned conjugate gradients from x0 = 0.  Returns
    ``(x, SolveInfo)``.  Works on tensors of any shape (lattice or flat)."""
    M = M or (lambda v: v)
    x = torch.zeros_like(b)
    r = b                      # b - A(0)
    res0 = _host(_norm(r), stats)
    thr = _threshold(tol, reduction, res0)
    z = M(r)
    p = z
    rz = _dot(r, z)
    res, it = res0, 0
    while res > thr and it < max_steps:
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        res = _host(_norm(r), stats)
        it += 1
        if res <= thr or it >= max_steps:
            break              # the next direction would go unused
        z = M(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, SolveInfo(it, res, res0, res <= thr)


def _back_substitute(R, g, j):
    y = np.zeros(j)
    for i in range(j - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:j] @ y[i + 1:j]) / R[i, i]
    return y


def fgmres(A: Callable, b, M: Callable, *, tol: float = 1e-10,
           reduction: float | None = None, max_steps: int = 1000,
           restart: int = 50, stats: dict | None = None):
    """Flexible GMRES, right-preconditioned and restarted (deal.II
    SolverFGMRES), from x0 = 0, with classical Gram-Schmidt applied twice
    (CGS2) against the basis built so far.  The Hessenberg least-squares
    problem (Givens rotations, back substitution) runs on the host in
    float64.  Returns ``(x, SolveInfo)``."""
    n = b.shape[0]
    m = restart
    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    res0 = _host(_norm(b), stats)
    thr = _threshold(tol, reduction, res0)
    V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)
    Z = torch.empty((m, n), dtype=b.dtype, device=b.device)
    res, tot_it = res0, 0
    while res > thr and tot_it < max_steps:
        r = b - A(x) if tot_it else b
        beta = res0 if not tot_it else _host(_norm(r), stats)
        V[0] = r / max(beta, tiny)
        R = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        res, j = beta, 0
        while j < m and res > thr and tot_it + j < max_steps:
            z = M(V[j])
            w = A(z)
            Vj = V[:j + 1]
            h1 = torch.mv(Vj, w)
            w = w - torch.mv(Vj.T, h1)
            h2 = torch.mv(Vj, w)
            w = w - torch.mv(Vj.T, h2)
            hnorm = _norm(w)
            hv = _host(torch.cat([h1 + h2, hnorm[None]]), stats)
            h, hnew = hv[:-1], hv[-1]
            V[j + 1] = w / max(hnew, tiny)
            Z[j] = z
            for i in range(j):
                hi, hi1 = h[i], h[i + 1]
                h[i] = cs[i] * hi + sn[i] * hi1
                h[i + 1] = -sn[i] * hi + cs[i] * hi1
            hj = h[j]
            denom = math.sqrt(hj * hj + hnew * hnew)
            c, s = (hj / denom, hnew / denom) if denom > 0 else (1.0, 0.0)
            h[j] = denom
            cs[j], sn[j] = c, s
            g[j], g[j + 1] = c * g[j], -s * g[j]
            R[:j + 1, j] = h[:j + 1]
            res = abs(float(g[j + 1]))
            j += 1
        if j:
            y = torch.as_tensor(_back_substitute(R, g, j), dtype=b.dtype,
                                device=b.device)
            x = x + torch.mv(Z[:j].T, y)
        tot_it += j
    return x, SolveInfo(tot_it, res, res0, res <= thr)


def lanczos_max_eig(A: Callable, n: int, steps: int = 8, v0=None, *,
                    dtype=torch.float64, device="cpu",
                    stats: dict | None = None) -> float:
    """Largest-eigenvalue estimate by ``steps`` Lanczos iterations (feeds the
    Chebyshev smoother bounds).  ``v0`` is the start vector (NumPy, length
    n); by default it is ``numpy.random.default_rng(0).standard_normal(n)``,
    so every device draws the same vector."""
    if v0 is None:
        v0 = np.random.default_rng(0).standard_normal(n)
    v = torch.as_tensor(np.array(v0), dtype=dtype, device=device)
    v = v / _norm(v)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=device)
    alphas, betas = [], []
    for _ in range(steps):
        w = A(v) - beta * v_prev
        alpha = _dot(v, w)
        w = w - alpha * v
        beta_new = _norm(w)
        alphas.append(alpha)
        betas.append(beta_new)
        v_prev = v
        v = w / torch.clamp(beta_new, min=1e-300)
        beta = beta_new
    ab = np.asarray(_host(torch.stack(alphas + betas), stats))
    alphas, betas = ab[:steps], ab[steps:]
    T = np.diag(alphas)
    for i in range(steps - 1):
        T[i + 1, i] = T[i, i + 1] = betas[i]
    return float(np.linalg.eigvalsh(T).max())
