"""Geometric multigrid on the Q1 background lattice.

Counterpart of the lattice path of
``fictitious_domain_al_preconditioners_tpu.precond.gmg``.  Coarsening is
exact 2:1 grid coarsening; every level's operator is re-discretized
(including the AL term, whose per-level coupling table is rebuilt by
relocating the immersed quadrature points); transfers are the Q1 lattice
interleaves; smoothers are Chebyshev with Lanczos bounds; the coarse solve is
a dense inverse built in float64 on the host.  Every level vector is an
(ny, nx) lattice tensor.  The V-cycle is symmetric, so it is a valid CG
preconditioner.

The cycle runs in its own precision (``build_gmg(dtype=...)``), which may be
lower than the caller's: with bfloat16 the level vectors, masks, diagonals
and transfers are bfloat16, the Lanczos bounds are estimated in float32 and
the coarse inverse is held and applied in float32 (``gmg.py:202-265,
364-456`` of the reference); ``apply`` casts at its boundary.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.krylov import lanczos_max_eig
from ..parallel.lattice import lattice_prolong, lattice_restrict
from .chebyshev import chebyshev

__all__ = ["FusedSmoother", "LatticeTransfer2D", "GMG", "build_gmg"]


@dataclass
class LatticeTransfer2D:
    """Q1 transfer between two lattice levels: ``mv`` prolongs coarse ->
    fine, ``rmv`` restricts fine -> coarse (its adjoint)."""

    fine_lat: tuple      # (ny, nx) of the finer level
    coarse_lat: tuple
    shape: tuple         # (n_fine, n_coarse) dof counts

    def mv(self, xc2):
        return lattice_prolong(xc2)

    def rmv(self, xf2):
        return lattice_restrict(xf2)


class FusedSmoother:
    """Smoother with optionally fused V-cycle stages: ``__call__(b) -> x``
    is the plain sweep, ``pre(b) -> (x, b - A x)`` emits the residual from the
    same pass and ``post(b, x0) -> x0 + cheb(b - A x0)`` folds the
    post-smooth after the coarse correction.  The V-cycle uses them when
    present."""

    def __init__(self, smooth, pre=None, post=None):
        self._smooth = smooth
        self.pre = pre
        self.post = post

    def __call__(self, b):
        return self._smooth(b)


@dataclass
class _Level:
    space: object
    op: object               # masked lattice apply
    diag_inv: torch.Tensor
    mask: torch.Tensor       # free-dof mask, float 0/1, lattice shape
    smoother: object
    prolong: LatticeTransfer2D | None  # from the next-coarser level
    lam_max: float


class GMG:
    """V-cycle preconditioner on lattice tensors: ``apply(b) -> x``.
    ``dtype`` is the cycle precision; ``apply`` takes ``b`` in any floating
    dtype and returns ``x`` in ``b``'s."""

    def __init__(self, levels, coarse_inv, dtype):
        self.levels = levels
        self.coarse_inv = coarse_inv
        self.dtype = dtype

    def _coarse_solve(self, b):
        # the dense inverse at its own (at least float32) precision
        x = self.coarse_inv @ b.reshape(-1).to(self.coarse_inv.dtype)
        return x.to(self.dtype).reshape(b.shape)

    def _vcycle(self, li: int, b):
        level = self.levels[li]
        if li == len(self.levels) - 1:
            return self._coarse_solve(b)
        sm = level.smoother
        pre = getattr(sm, "pre", None)
        if pre is not None:
            x, r = pre(b)
        else:
            x = sm(b)
            r = b - level.op(x)
        coarse = self.levels[li + 1]
        rc = (coarse.mask * coarse.prolong.rmv(r)).to(self.dtype)
        xc = self._vcycle(li + 1, rc)
        x = x + (level.mask * coarse.prolong.mv(xc)).to(self.dtype)
        post = getattr(sm, "post", None)
        if post is not None:
            x = post(b, x)
        else:
            x = x + sm(b - level.op(x))
        return x

    def apply(self, b):
        return self._vcycle(0, b.to(self.dtype)).to(b.dtype)


# hierarchy and smoother constants of the reference (precond/gmg.py:272-276)
MIN_CELLS = 4          # coarsest level: at least this many cells per axis
EIG_RATIO = 30.0       # Chebyshev targets [lam_max / EIG_RATIO, 1.1 lam_max]
LANCZOS_STEPS = 10


def build_gmg(fine_space, op_factory, *, free_mask, smoother_degree: int = 4,
              lanczos_start=None, dtype=torch.float64,
              stats: dict | None = None) -> GMG:
    """Build a lattice-resident GMG hierarchy on a 2D Q1 space.

    ``op_factory(space) -> (op, diag, smoother_builder)``: ``op`` is the
    Dirichlet-masked level operator on (ny, nx) tensors
    (``m*A(m*x) + (1-m)*x``), ``diag`` its assembled diagonal before masking
    (flat, dof order), and ``smoother_builder(lam, degree, eig_ratio)`` an
    optional fused smoother; without it the level gets :func:`chebyshev`
    over ``op``.  ``free_mask`` is the fine-level Dirichlet mask (bool tensor,
    flat); coarse masks are derived from the same constrained faces.
    ``lanczos_start(level_index, n) -> ndarray`` optionally supplies each
    level's Lanczos start vector.  ``dtype`` is the cycle precision: the
    level ops take and return it; with bfloat16 the Lanczos runs in float32
    and the coarse inverse is float32."""
    def coarsenable(sp):
        g = sp.grid
        return not (any(n % 2 != 0 for n in g.ncells)
                    or min(g.ncells) // 2 < MIN_CELLS)

    spaces = [fine_space]
    while coarsenable(spaces[-1]):
        spaces.append(spaces[-1].coarse_space())

    device = free_mask.device
    fine_mask = free_mask.cpu().numpy()
    constrained_ids = [bid for bid in range(2 * fine_space.grid.dim)
                       if not fine_mask[fine_space.boundary_dof_mask([bid])]
                       .any()]

    # Lanczos and the coarse inverse need more precision than bf16 keeps
    work_dt = torch.float32 if dtype == torch.bfloat16 else dtype
    levels = []
    for i, sp in enumerate(spaces):
        lat = tuple(reversed(sp.n_points_1d))
        if i == 0:
            m = fine_mask
        elif constrained_ids:
            m = ~sp.boundary_dof_mask(constrained_ids)
        else:
            m = np.ones(sp.n_dofs, dtype=bool)
        mask = torch.as_tensor(m.reshape(lat), device=device)
        op, diag, smoother_builder = op_factory(sp)
        diag = torch.as_tensor(np.asarray(diag, dtype=np.float64).reshape(lat),
                               device=device)
        maskf = mask.to(dtype)
        diag_inv = torch.where(mask, 1.0 / diag, 1.0).to(dtype)

        def lanc_mv(v, op=op, di=diag_inv, lat=lat):
            return (di * op(v.reshape(lat).to(dtype))).reshape(-1).to(work_dt)

        v0 = lanczos_start(i, sp.n_dofs) if lanczos_start is not None else None
        lam = lanczos_max_eig(lanc_mv, sp.n_dofs, steps=LANCZOS_STEPS, v0=v0,
                              dtype=work_dt, device=device, stats=stats)
        if smoother_builder is not None:
            smoother = smoother_builder(lam, degree=smoother_degree,
                                        eig_ratio=EIG_RATIO)
        else:
            smoother = chebyshev(op, diag_inv, lam, degree=smoother_degree,
                                 eig_ratio=EIG_RATIO)
        prolong = None
        if i > 0:
            finer = spaces[i - 1]
            prolong = LatticeTransfer2D(tuple(reversed(finer.n_points_1d)),
                                        lat, (finer.n_dofs, sp.n_dofs))
        levels.append(_Level(sp, op, diag_inv, maskf, smoother, prolong, lam))

    # coarse dense inverse: columns op(e_k) in the cycle precision, inverted
    # on the host in float64, held in the working precision
    coarse = levels[-1]
    lat = tuple(reversed(coarse.space.n_points_1d))
    nco = coarse.space.n_dofs
    eye = torch.eye(nco, dtype=dtype, device=device)
    dense = torch.stack([coarse.op(eye[k].reshape(lat)).reshape(-1)
                         for k in range(nco)], dim=1)
    inv = np.linalg.inv(dense.cpu().double().numpy())
    return GMG(levels, torch.as_tensor(inv, dtype=work_dt, device=device),
               dtype)
