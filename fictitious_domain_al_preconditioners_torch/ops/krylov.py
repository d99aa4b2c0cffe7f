"""Krylov solvers with deal.II-style controls: CG (single and batched),
MINRES, GMRES and flexible GMRES (CGS2), and a Lanczos largest-eigenvalue
estimate.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.krylov``.  The
``lax.while_loop`` bodies become Python loops; each iteration reads what its
stopping test needs on the host in one read (one ``.item()``-style sync per
step of every solver).  Callers that want those syncs counted pass a
``stats`` dict, whose ``"host_syncs"`` entry is incremented once per
device-to-host read.

Control semantics (as in the reference):
  - ``tol``: absolute residual tolerance
  - ``reduction``: stop at ``max(tol, reduction * ||r0||)``
  - ``max_steps``: iteration cap; with ``fixed_iters=True`` the run counts as
    converged regardless (deal.II ``IterationNumberControl``)

CG and MINRES stop on their recurrence residual, as the reference does: in
float32 it keeps falling after the true residual has stalled.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["SolveInfo", "cg", "batched_cg", "minres", "fgmres", "gmres",
           "lanczos_max_eig"]


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


def cg(A: Callable, b, M: Optional[Callable] = None, x0=None, *,
       tol: float = 1e-10, reduction: float | None = None,
       max_steps: int = 100, fixed_iters: bool = False,
       stats: dict | None = None):
    """Preconditioned conjugate gradients from ``x0`` (default 0).  Returns
    ``(x, SolveInfo)``.  Works on tensors of any shape (lattice or flat)."""
    M = M or (lambda v: v)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b                      # b - A(0)
    else:
        x = x0
        r = b - A(x0)
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
    return x, SolveInfo(it, res, res0, res <= thr or fixed_iters)


def batched_cg(A: Callable, B, M: Optional[Callable] = None, *,
               tol: float = 1e-12, reduction: float | None = None,
               max_steps: int = 1000, stats: dict | None = None):
    """CG on k independent systems sharing one batched operator, from 0.

    ``B`` is (n, k); ``A`` and ``M`` map (n, k) -> (n, k) column by column.
    Inner products are per column; converged columns freeze while the rest
    iterate.  One host read per step (the k residual norms).  Returns
    ``(X, SolveInfo)`` with the largest residuals."""
    M = M or (lambda v: v)
    X = torch.zeros_like(B)
    R = B                              # B - A(0)
    res0 = np.asarray(_host(torch.sqrt(torch.sum(R * R, dim=0)), stats))
    thr = (np.maximum(tol, reduction * res0) if reduction is not None
           else np.full_like(res0, tol))
    thr_t = torch.as_tensor(thr, dtype=B.dtype, device=B.device)
    res_t = torch.as_tensor(res0, dtype=B.dtype, device=B.device)
    Z = M(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    res, it = res0, 0
    while np.any(res > thr) and it < max_steps:
        active = res_t > thr_t
        AP = A(P)
        pAp = torch.sum(P * AP, dim=0)
        alpha = torch.where(active, rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        res_t = torch.sqrt(torch.sum(R * R, dim=0))
        res = np.asarray(_host(res_t, stats))
        it += 1
        if not np.any(res > thr) or it >= max_steps:
            break              # the next directions would go unused
        Z = M(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        P = torch.where(active[None, :], Z + beta[None, :] * P, P)
        rz = rz_new
    return X, SolveInfo(it, float(res.max()), float(res0.max()),
                        bool(np.all(res <= thr)))


def minres(A: Callable, b, M: Optional[Callable] = None, x0=None, *,
           tol: float = 1e-10, reduction: float | None = None,
           max_steps: int = 1000, fixed_iters: bool = False,
           stats: dict | None = None):
    """Preconditioned MINRES (``M`` symmetric positive definite), deal.II
    ``SolverMinRes``.  The scalar recurrence (Lanczos coefficients, Givens
    rotation, residual estimate) runs on the host in float64 from one read of
    (alpha, beta) per step.  Returns ``(x, SolveInfo)``."""
    M = M or (lambda v: v)
    if x0 is None:
        x = torch.zeros_like(b)
        r1 = b
    else:
        x = x0
        r1 = b - A(x0)
    y = M(r1)
    beta1 = math.sqrt(max(_host(_dot(r1, y), stats), 0.0))
    thr = _threshold(tol, reduction, beta1)
    eps = torch.finfo(b.dtype).tiny
    r2 = r1
    oldb, beta, epsln, dbar, cs, sn = 0.0, beta1, 0.0, 0.0, -1.0, 0.0
    phibar = beta1
    w = w2 = torch.zeros_like(b)
    it = 0
    while phibar > thr and it < max_steps:
        v = y / max(beta, eps)
        y = A(v)
        if it > 0:
            y = y - (beta / max(oldb, eps)) * r1
        alfa = _dot(v, y)
        y = y - (alfa / max(beta, eps)) * r2
        r1, r2 = r2, y
        y = M(r2)
        oldb = beta
        beta_sq = _dot(r2, y)
        alfa, beta_sq = _host(torch.stack([alfa, beta_sq]), stats)
        beta = math.sqrt(max(beta_sq, 0.0))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = max(math.sqrt(gbar ** 2 + beta ** 2), eps)
        cs, sn = gbar / gamma, beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        it += 1
    return x, SolveInfo(it, phibar, beta1, phibar <= thr or fixed_iters)


def _back_substitute(R, g, j):
    y = np.zeros(j)
    for i in range(j - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:j] @ y[i + 1:j]) / R[i, i]
    return y


def _gmres_core(A, b, M, *, tol, reduction, max_steps, restart, stats,
                flexible):
    """Restarted right-preconditioned GMRES from x0 = 0 with classical
    Gram-Schmidt applied twice (CGS2) against the basis built so far.  The
    Hessenberg least-squares problem (Givens rotations, back substitution)
    runs on the host in float64.  ``flexible`` keeps the preconditioned
    directions Z (FGMRES); otherwise the update is ``M(V y)``."""
    n = b.shape[0]
    m = restart
    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    res0 = _host(_norm(b), stats)
    thr = _threshold(tol, reduction, res0)
    V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)
    Z = (torch.empty((m, n), dtype=b.dtype, device=b.device) if flexible
         else None)
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
            if flexible:
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
            if flexible:
                x = x + torch.mv(Z[:j].T, y)
            else:
                x = x + M(torch.mv(V[:j].T, y))
        tot_it += j
    return x, SolveInfo(tot_it, res, res0, res <= thr)


def fgmres(A: Callable, b, M: Callable, *, tol: float = 1e-10,
           reduction: float | None = None, max_steps: int = 1000,
           restart: int = 50, stats: dict | None = None):
    """Flexible GMRES, right-preconditioned and restarted (deal.II
    SolverFGMRES), from x0 = 0: ``M`` may change between steps (an inner
    iterative solve).  Returns ``(x, SolveInfo)``."""
    return _gmres_core(A, b, M, tol=tol, reduction=reduction,
                       max_steps=max_steps, restart=restart, stats=stats,
                       flexible=True)


def gmres(A: Callable, b, M: Optional[Callable] = None, *,
          tol: float = 1e-10, reduction: float | None = None,
          max_steps: int = 1000, restart: int = 50,
          stats: dict | None = None):
    """Right-preconditioned restarted GMRES (deal.II SolverGMRES), from
    x0 = 0.  Returns ``(x, SolveInfo)``."""
    return _gmres_core(A, b, M or (lambda v: v), tol=tol,
                       reduction=reduction, max_steps=max_steps,
                       restart=restart, stats=stats, flexible=False)


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
