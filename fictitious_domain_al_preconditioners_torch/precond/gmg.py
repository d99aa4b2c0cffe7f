"""Geometric multigrid on the uniform background grid.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.precond.gmg``.
Coarsening is exact 2:1 grid coarsening; every level's operator is
re-discretized (including the AL term, whose per-level coupling table is
rebuilt by relocating the immersed quadrature points); smoothers are
Chebyshev with Lanczos bounds; the coarse solve is a dense inverse built in
float64 on the host.  The V-cycle is symmetric, so it is a valid CG
preconditioner.  The hierarchies:

- :func:`build_gmg`, the lattice hierarchy of a 2D Q1 space: every level
  vector is an (ny, nx) lattice tensor and the transfers are the Q1 lattice
  interleaves;
- :func:`build_gmg_sharded` (:class:`ShardedGMG`), the same hierarchy over
  the row blocks of ``parallel.mesh``: the fine levels on each rank's rows,
  the coarse ones replicated (a :class:`GMG`);
- :func:`build_gmg_flat_sharded`, the flat hierarchy over contiguous ranges
  of each level vector, the same :class:`ShardedGMG` (the transfers
  :class:`ProlongationRows` on all-gathered vectors);
- :func:`build_gmg_flat`, the flat hierarchy of any continuous space,
  uniform or locally refined (``gmg.py:272-459`` of the reference without
  the lattice branch): level
  vectors are flat, of ``n_comp·n`` entries for a component-major vector
  field (the Stokes velocity), and the transfers are the FE embedding
  (:class:`Prolongation`, per component :class:`VectorProlongation`).

The first and the last share the cycle (:class:`GMG`).  The cycle runs in
its own precision (``dtype``), which may be lower than the caller's: with
bfloat16 the level vectors, masks, diagonals and transfers are bfloat16, the
Lanczos bounds are estimated in float32 and the coarse inverse is held and
applied in float32 (``gmg.py:202-265, 364-456`` of the reference);
``apply`` casts at its boundary.  Each :meth:`GMG.apply` is a ``gmg.vcycle``
span and each level visit inside it a ``gmg.level`` span (``level``, the
level vector's ``shape``), the coarse solve the last (:mod:`..tracer`); on a
CUDA card the visits below level 0 run inside their graph's replay, a
``gmg.graph`` span (``levels``, the levels replayed), and are spanned only
in the first V-cycle, which runs them eagerly and captures them.
"""

from __future__ import annotations

import collections
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kernels import GRAPH_CALLS, LAUNCHES, recording_launches
from ..ops.krylov import lanczos_max_eig
from ..parallel.lattice import lattice_prolong, lattice_restrict
from ..parallel.mesh import inner_product, prolong_block, restrict_block
from ..utils.carry import block_lanczos_start
from ..tracer import span
from .chebyshev import chebyshev

__all__ = ["FusedSmoother", "LatticeTransfer2D", "Prolongation",
           "ProlongationRows", "VectorProlongation", "make_prolongation",
           "graph_eligible",
           "GMG", "ShardedGMG",
           "build_gmg", "build_gmg_sharded", "build_gmg_flat",
           "build_gmg_flat_sharded", "level_spaces"]


class Prolongation:
    """FE embedding coarse -> fine on flat vectors: ``mv`` is a gather and a
    weighted row sum, ``rmv`` (the restriction) its ``index_add_``
    transpose.  ``cell_dofs[f]`` are the coarse dofs of the coarse cell
    holding fine dof f and ``phi[f]`` their basis values there."""

    def __init__(self, cell_dofs, phi, shape, *, device, dtype):
        self.cell_dofs = torch.as_tensor(np.asarray(cell_dofs),
                                         dtype=torch.int64, device=device)
        self.phi = torch.as_tensor(np.asarray(phi), dtype=dtype,
                                   device=device)
        self.shape = tuple(shape)            # (n_fine, n_coarse)

    def mv(self, xc):
        return (xc[self.cell_dofs] * self.phi.to(xc.dtype)).sum(dim=1)

    def rmv(self, xf):
        out = torch.zeros(self.shape[1], dtype=xf.dtype, device=xf.device)
        return out.index_add_(0, self.cell_dofs.reshape(-1),
                              (self.phi.to(xf.dtype) * xf[:, None])
                              .reshape(-1))


class ProlongationRows:
    """A rank's rows of a :class:`Prolongation`'s applies to a whole input
    vector: ``mv(xc)`` its fine rows ``[first, last)`` of ``P xc``, or, with
    ``restrict``, ``rmv(xf)`` its coarse rows ``[first, last)`` of ``Pᵀ
    xf`` (the fine rows that reach them, the others dropped)."""

    def __init__(self, P: Prolongation, first: int, last: int, *,
                 restrict: bool = False):
        self.n = last - first
        if not restrict:
            self.cell_dofs = P.cell_dofs[first:last]
            self.phi = P.phi[first:last]
            return
        dofs = P.cell_dofs
        own = (dofs >= first) & (dofs < last)
        fine = own.any(dim=1)
        self.fine = torch.nonzero(fine).reshape(-1)
        self.cell_dofs = torch.where(own, dofs - first, self.n)[fine]
        self.phi = P.phi[fine]

    def mv(self, xc):
        return (xc[self.cell_dofs] * self.phi.to(xc.dtype)).sum(dim=1)

    def rmv(self, xf):
        out = torch.zeros(self.n + 1, dtype=xf.dtype, device=xf.device)
        out.index_add_(0, self.cell_dofs.reshape(-1),
                       (self.phi.to(xf.dtype) * xf[self.fine][:, None])
                       .reshape(-1))
        return out[:self.n]


def make_prolongation(fine, coarse, *, device, dtype=torch.float64):
    """FE-embedding prolongation from ``coarse`` to ``fine`` (the same
    element on a 2:1 coarser grid): every fine dof point is located in its
    coarse cell and the coarse basis is tabulated there; a locally refined
    space tabulates its folded basis (``tabulate_at``), so the transfer
    carries the hanging-node constraints."""
    if hasattr(coarse, "tabulate_at"):
        dofs, phi = coarse.tabulate_at(fine.dof_points)
    else:
        cells, refs = coarse.grid.locate(fine.dof_points)
        dofs, phi = coarse.cell_dofs[cells], coarse.fe.tabulate(refs)
    return Prolongation(dofs, phi, (fine.n_dofs, coarse.n_dofs),
                        device=device, dtype=dtype)


class VectorProlongation:
    """Componentwise :class:`Prolongation` of a component-major vector
    field: every component goes through the scalar transfer (the 'vector
    constant modes' of the reference's AMG setup, utilities.h:304-317)."""

    def __init__(self, scalar: Prolongation, n_comp: int):
        self.scalar = scalar
        self.n_comp = n_comp
        self.shape = (scalar.shape[0] * n_comp, scalar.shape[1] * n_comp)

    def mv(self, xc):
        p = self.scalar
        x2 = xc.reshape(self.n_comp, p.shape[1])
        return (x2[:, p.cell_dofs] * p.phi.to(xc.dtype)).sum(dim=2).reshape(-1)

    def rmv(self, xf):
        p = self.scalar
        x2 = xf.reshape(self.n_comp, p.shape[0])
        out = torch.zeros((self.n_comp, p.shape[1]), dtype=xf.dtype,
                          device=xf.device)
        return out.index_add_(
            1, p.cell_dofs.reshape(-1),
            (p.phi.to(xf.dtype) * x2[:, :, None]).reshape(self.n_comp, -1)
        ).reshape(-1)


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
    """Smoother with fused V-cycle stages: ``__call__(b) -> x`` is the plain
    sweep, ``pre(b) -> (x, b - A x)`` emits the residual from the same pass
    and ``post(b, x0) -> x0 + cheb(b - A x0)`` folds the post-smooth after
    the coarse correction."""

    def __init__(self, smooth, pre, post):
        self._smooth = smooth
        self.pre = pre
        self.post = post

    def __call__(self, b):
        return self._smooth(b)


class _Level:
    """One level of a hierarchy: ``op`` the masked level operator,
    ``mask`` the free-dof mask (float 0/1, level vector shape), ``prolong``
    the transfer from the next-coarser level (None on the first).

    The smoother's form is fixed when the smoother is set: a
    :class:`FusedSmoother` gives its own ``pre(b) -> (x, b - op(x))`` and
    ``post(b, x) -> x + S(b - op(x))``, any other smoother ``S`` (a plain
    callable, :func:`chebyshev`) the unfused pair over ``op``."""

    def __init__(self, space, op, diag_inv, mask, smoother, prolong,
                 lam_max):
        self.space = space
        self.op = op
        self.diag_inv = diag_inv
        self.mask = mask
        self.smoother = smoother
        self.prolong = prolong
        self.lam_max = lam_max

    @property
    def smoother(self):
        return self._smoother

    @smoother.setter
    def smoother(self, sm):
        self._smoother = sm
        if isinstance(sm, FusedSmoother):
            self.pre, self.post = sm.pre, sm.post
        else:
            self.pre, self.post = self._unfused_pre, self._unfused_post

    def _unfused_pre(self, b):
        x = self._smoother(b)
        return x, b - self.op(x)

    def _unfused_post(self, b, x):
        return x + self._smoother(b - self.op(x))

    def step(self, b, restrict, prolong, coarse_mask, below, dtype):
        """One visit of the V-cycle on ``b``: pre-smooth, the masked
        restriction of the residual to the next level cast to the cycle's
        ``dtype``, ``below`` on it (the cycle below this level), the masked
        prolongation of its correction, post-smooth."""
        x, r = self.pre(b)
        rc = (coarse_mask * restrict(r)).to(dtype)
        xc = below(rc)
        x = x + (self.mask * prolong(xc)).to(dtype)
        return self.post(b, x)


def graph_eligible(device, n_levels: int) -> bool:
    """Whether a hierarchy of ``n_levels`` on ``device`` runs the cycle
    below its first level as one CUDA graph: on a CUDA device, with a level
    below the first."""
    return torch.device(device).type == "cuda" and n_levels >= 2


class GMG:
    """V-cycle preconditioner: ``apply(b) -> x`` on the hierarchy's level
    vectors (lattice tensors or flat).
    ``dtype`` is the cycle precision; ``apply`` takes ``b`` in any floating
    dtype and returns ``x`` in ``b``'s.

    Where :func:`graph_eligible`, the cycle below level 0 (every visit of
    levels 1 … L-1, the transfers and the coarse solve) is captured as one
    CUDA graph at its first call and replayed after: the host launches
    level 0's kernels and one graph, whatever the depth.  The replay reads
    level 1's right-hand side from a static input and leaves its correction
    in a static output, which level 0 consumes at once.  Each replay adds
    the kernel-entry calls the capture recorded to ``ops.kernels.LAUNCHES``
    and ``ops.kernels.GRAPH_CALLS``; ``stats`` counts replays, captures,
    failed captures and the bytes the captures reserved
    (``models.session.SOLVE_COUNTERS``).  A capture that fails leaves the
    cycle eager for good."""

    def __init__(self, levels, coarse_inv, dtype, stats: dict | None):
        self.levels = levels
        self.coarse_inv = coarse_inv
        self.dtype = dtype
        self.stats = stats
        # the graph below level 0: None until the first call, False where
        # there is none (not eligible, or its capture failed)
        self._graph = None
        self._static = None          # (input, output) of the graph
        self._tally = {}             # LAUNCHES keys of one replay
        self._calls = {}             # GRAPH_CALLS records of one replay

    def _coarse_solve(self, b):
        # the dense inverse at its own (at least float32) precision; on a
        # CUDA device as a product and a row sum: a matrix-vector product
        # calls cuBLAS, which gives a graph's capture stream a workspace of
        # its own (32 MiB on sm_90) for the life of the process
        v = b.reshape(-1).to(self.coarse_inv.dtype)
        if v.device.type == "cuda":
            x = (self.coarse_inv * v).sum(dim=1)
        else:
            x = self.coarse_inv @ v
        return x.to(self.dtype).reshape(b.shape)

    def _count(self, key: str, n: int = 1):
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + n

    def _below(self, rc):
        """The cycle below level 0 on level 1's right-hand side ``rc``:
        replayed from its graph, captured at the first call where
        :func:`graph_eligible`, else level by level."""
        if self._graph is None:
            if graph_eligible(rc.device, len(self.levels)):
                return self._capture(rc)
            self._graph = False
        if self._graph is False:
            return self._vcycle(1, rc)
        static_in, static_out = self._static
        with span("gmg.graph", levels=len(self.levels) - 1):
            static_in.copy_(rc)
            self._graph.replay()
        for key, n in self._tally.items():
            LAUNCHES[key] += n
        GRAPH_CALLS.update(self._calls)
        self._count("vcycle_graph_replays")
        return static_out

    def _capture(self, rc):
        """The first call below level 0: the eager cycle, whose result is
        this call's (it also settles what the kernels set up once a
        process), then the capture of the same pass on a static input, on
        PyTorch's capture stream.  The kernel-entry launches of the capture
        are recorded, not counted: they run at each replay.  The bytes the
        capture reserves (its private pool: the tail's intermediates and
        its output) are counted in ``vcycle_graph_pool_bytes``."""
        xc = self._vcycle(1, rc)
        graph = torch.cuda.CUDAGraph()
        static_in = torch.empty_like(rc)
        # the capture empties the allocator's cache itself; emptied here
        # first, the reserved bytes grow by the capture's pool alone
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(rc.device)
        try:
            # the outer stream context restores the current stream where a
            # failed capture leaves the capture stream current
            with torch.cuda.stream(torch.cuda.current_stream(rc.device)), \
                    torch.cuda.graph(graph), recording_launches() as rec:
                static_out = self._vcycle(1, static_in)
        except RuntimeError:
            self._graph = False
            self._count("vcycle_graph_failures")
        else:
            self._graph = graph
            self._static = (static_in, static_out)
            self._tally = collections.Counter(key for key, _ in rec)
            self._calls = collections.Counter(call for _, call in rec)
            self._count("vcycle_graph_captures")
            self._count("vcycle_graph_pool_bytes",
                        torch.cuda.memory_reserved(rc.device) - reserved)
        return xc

    def _vcycle(self, li: int, b):
        with span("gmg.level", level=li, shape=b.shape):
            if li == len(self.levels) - 1:
                return self._coarse_solve(b)
            coarse = self.levels[li + 1]
            below = (self._below if li == 0
                     else functools.partial(self._vcycle, li + 1))
            return self.levels[li].step(b, coarse.prolong.rmv,
                                        coarse.prolong.mv, coarse.mask,
                                        below, self.dtype)

    def apply(self, b):
        with span("gmg.vcycle", levels=len(self.levels)):
            return self._vcycle(0, b.to(self.dtype)).to(b.dtype)


# hierarchy and smoother constants of the reference (precond/gmg.py:272-276)
MIN_CELLS = 4          # coarsest level: at least this many cells per axis
EIG_RATIO = 30.0       # Chebyshev targets [lam_max / EIG_RATIO, 1.1 lam_max]
LANCZOS_STEPS = 10


def level_spaces(fine_space):
    """The hierarchy's spaces, fine first: 2:1 coarsening while every axis
    has an even number of cells and at least ``2 * MIN_CELLS``; a locally
    refined space clamps its deepest level while its finest level keeps at
    least ``2 * MIN_CELLS`` cells per axis (``can_coarsen``, the tree
    truncated down to the uniform base grid and below)."""
    def coarsenable(sp):
        if hasattr(sp, "can_coarsen"):
            return sp.can_coarsen(MIN_CELLS)
        g = sp.grid
        return not (any(n % 2 != 0 for n in g.ncells)
                    or min(g.ncells) // 2 < MIN_CELLS)

    spaces = [fine_space]
    while coarsenable(spaces[-1]):
        spaces.append(spaces[-1].coarse_space())
    return spaces


def _constrained_faces(fine_space, fine_mask):
    """Boundary ids whose dofs the fine mask (of the first component)
    holds fixed; the coarse levels constrain the same faces."""
    scalar = fine_mask[:fine_space.n_dofs]
    return [bid for bid in range(2 * fine_space.grid.dim)
            if not scalar[fine_space.boundary_dof_mask([bid])].any()]


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
    spaces = level_spaces(fine_space)
    levels = _lattice_levels(spaces, 0, op_factory, free_mask=free_mask,
                             smoother_degree=smoother_degree,
                             lanczos_start=lanczos_start, dtype=dtype,
                             stats=stats)
    return GMG(levels, _coarse_inverse(levels[-1], dtype), dtype, stats)


def _level_masks(fine_space, free_mask, n_comp: int = 1):
    """``mask(sp, i)``: the free-dof mask of level ``i`` (flat bool NumPy
    of ``n_comp·n``), the fine mask on the fine level and the same
    constrained faces below, in every component."""
    fine_mask = free_mask.cpu().numpy()
    constrained_ids = _constrained_faces(fine_space, fine_mask)

    def mask(sp, i):
        if i == 0:
            return fine_mask
        if constrained_ids:
            return np.tile(~sp.boundary_dof_mask(constrained_ids), n_comp)
        return np.ones(n_comp * sp.n_dofs, dtype=bool)

    return mask


def _work_dtype(dtype):
    # Lanczos and the coarse inverse need more precision than bf16 keeps
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _level(i, sp, n, own, mask, op, diag, smoother_builder=None,
           prolong=None, *, smoother_degree, lanczos_start, dtype, stats,
           inner=None):
    """Level ``i`` of a hierarchy, of ``n`` dofs, held on the rows ``own``
    (a slice of the flat level vector; all of them where serial): ``op``
    on level vectors of ``mask``'s shape (bool, the free dofs of those
    rows), its diagonal inverse from the whole flat assembled ``diag``
    (float64 NumPy or a tensor) cut to ``own``, its Lanczos bound from
    those rows of the start vector (``lanczos_start(i, n)`` or
    ``default_rng(0)``, the products ``inner``: all-reduced where
    sharded), smoothed by the fused smoother of ``smoother_builder`` or the
    unfused Chebyshev over ``op``."""
    device = mask.device
    shape = tuple(mask.shape)
    work_dt = _work_dtype(dtype)
    diag = np.asarray(diag.cpu() if torch.is_tensor(diag) else diag,
                      dtype=np.float64)
    diag = torch.as_tensor(diag.reshape(-1)[own].reshape(shape),
                           device=device)
    diag_inv = torch.where(mask, 1.0 / diag, 1.0).to(dtype)

    def lanc_mv(v):
        return (diag_inv * op(v.reshape(shape).to(dtype))).reshape(-1).to(
            work_dt)

    v0 = block_lanczos_start(lanczos_start, i, n, own.start, own.stop, 1)
    lam = lanczos_max_eig(lanc_mv, own.stop - own.start, steps=LANCZOS_STEPS,
                          v0=v0, dtype=work_dt, device=device, stats=stats,
                          inner=inner)
    if smoother_builder is not None:
        smoother = smoother_builder(lam, degree=smoother_degree,
                                    eig_ratio=EIG_RATIO)
    else:
        smoother = chebyshev(op, diag_inv, lam, degree=smoother_degree,
                             eig_ratio=EIG_RATIO)
    return _Level(sp, op, diag_inv, mask.to(dtype), smoother, prolong, lam)


def _lattice_levels(spaces, first, op_factory, *, free_mask, smoother_degree,
                    lanczos_start, dtype, stats, fine_space=None):
    """The :class:`_Level` list of the lattice levels ``spaces``, the first
    of which is level ``first`` of the hierarchy of ``fine_space`` (default
    ``spaces[0]``); the first one has no transfer."""
    level_mask = _level_masks(fine_space or spaces[0], free_mask)
    levels = []
    for j, sp in enumerate(spaces):
        i = first + j
        lat = tuple(reversed(sp.n_points_1d))
        mask = torch.as_tensor(level_mask(sp, i).reshape(lat),
                               device=free_mask.device)
        op, diag, smoother_builder = op_factory(sp)
        prolong = None
        if j > 0:
            finer = spaces[j - 1]
            prolong = LatticeTransfer2D(tuple(reversed(finer.n_points_1d)),
                                        lat, (finer.n_dofs, sp.n_dofs))
        levels.append(_level(
            i, sp, sp.n_dofs, slice(0, sp.n_dofs), mask, op, diag,
            smoother_builder, prolong, smoother_degree=smoother_degree,
            lanczos_start=lanczos_start, dtype=dtype, stats=stats))
    return levels


def _coarse_inverse(coarse, dtype):
    """The coarse level's dense inverse: columns op(e_k) in the cycle
    precision, inverted on the host in float64, held in the working
    precision."""
    shape = tuple(coarse.mask.shape)         # a lattice, or flat
    nco = coarse.mask.numel()
    device = coarse.mask.device
    eye = torch.eye(nco, dtype=dtype, device=device)
    dense = torch.stack([coarse.op(eye[k].reshape(shape)).reshape(-1)
                         for k in range(nco)], dim=1)
    inv = np.linalg.inv(dense.cpu().double().numpy())
    return torch.as_tensor(inv, dtype=_work_dtype(dtype), device=device)


class ShardedGMG:
    """The V-cycle over a rank's rows (``parallel.mesh``): the distributed
    levels hold this rank's rows of their level vectors (``blocks[i]``:
    lattice row blocks, or ranges of a flat vector), smoothed by a fused
    smoother (``pre``/``post``) or the unfused Chebyshev over the level's
    sharded operator; below them the replicated ``tail`` (a :class:`GMG`
    on whole level vectors, the same on every rank) runs the rest of the
    cycle and the dense coarse inverse.  ``transfers[i] = (restrict,
    prolong)`` move level ``i``'s rows to the next level's (this rank's
    rows, or the whole first tail level after the last distributed one) and
    back.  A one-level hierarchy (``direct``) has its fine level in the
    tail too: the cycle is the tail's dense inverse on the all-gathered
    vector (``transfers[0]`` gathers and cuts), as the serial cycle of one
    level is its coarse solve.  ``apply`` takes and returns this rank's
    rows of the fine level."""

    def __init__(self, levels, blocks, tail: GMG, mesh, dtype, transfers,
                 direct: bool = False):
        self.levels = levels
        self.blocks = blocks
        self.tail = tail
        self.mesh = mesh
        self.dtype = dtype
        self.transfers = transfers
        self.direct = direct

    def _vcycle(self, li: int, b):
        if self.direct:
            gather, cut = self.transfers[0]
            return cut(self.tail._coarse_solve(gather(b)))
        restrict, prolong = self.transfers[li]
        if li + 1 == len(self.levels):
            coarse = self.tail.levels[0]
            below = functools.partial(self.tail._vcycle, 0)
        else:
            coarse = self.levels[li + 1]
            below = functools.partial(self._vcycle, li + 1)
        return self.levels[li].step(b, restrict, prolong, coarse.mask, below,
                                    self.dtype)

    def apply(self, b):
        return self._vcycle(0, b.to(self.dtype)).to(b.dtype)


def build_gmg_sharded(fine_space, block_factory, op_factory, *, mesh,
                      blocks, free_mask, smoother_degree: int = 4,
                      lanczos_start=None, dtype=torch.float64,
                      stats: dict | None = None) -> ShardedGMG:
    """:func:`build_gmg` over row blocks: the first ``len(blocks)`` levels
    are distributed (``blocks[i]``, ``parallel.mesh.plan_levels``), the rest
    is the replicated tail built as :func:`build_gmg` builds a hierarchy.

    ``block_factory(i, space, blocks_i) -> (op, diag, smoother_builder)``
    gives a distributed level: ``op`` on this rank's rows (rows, nx),
    ``diag`` the level's whole assembled diagonal (flat NumPy) and a
    ``smoother_builder`` of a fused smoother on this rank's rows, or None
    for the unfused Chebyshev over ``op``; ``op_factory`` gives a tail
    level, as for :func:`build_gmg`.  The transfers exchange one halo row;
    the last distributed level's restriction is all-gathered into the
    tail's first level.  Every rank draws its Lanczos start vectors on the
    whole level (``lanczos_start(i, n)`` or ``default_rng(0)``) and keeps
    its rows, and all-reduces the Lanczos products: the bounds are those
    of the serial hierarchy up to the order of the sums."""
    spaces = level_spaces(fine_space)
    level_mask = _level_masks(fine_space, free_mask)
    nd = len(blocks)
    direct = nd == len(spaces)
    levels, transfers = [], []
    for i, (sp, bl) in enumerate(zip(spaces, blocks)):
        lo, hi = bl.rows(mesh.rank)
        mask = torch.as_tensor(level_mask(sp, i).reshape(bl.ny, bl.nx)[lo:hi],
                               device=free_mask.device)
        op, diag, smoother_builder = block_factory(i, sp, bl)
        levels.append(_level(
            i, sp, sp.n_dofs, slice(lo * bl.nx, hi * bl.nx), mask, op, diag,
            smoother_builder, smoother_degree=smoother_degree,
            lanczos_start=lanczos_start, dtype=dtype, stats=stats,
            inner=inner_product(mesh)))
        if direct:
            transfers.append((
                lambda r, f=bl: mesh.all_gather_rows(r, f.counts),
                lambda x, lo=lo, hi=hi: x[lo:hi]))
        elif i + 1 < nd:
            coarse = blocks[i + 1]
            transfers.append((
                lambda r, f=bl, c=coarse: restrict_block(mesh, f, c, r),
                lambda xc, f=bl, c=coarse: prolong_block(mesh, c, f, xc)))
        else:
            coarse = bl.coarse()
            transfers.append((
                lambda r, f=bl, c=coarse: mesh.all_gather_rows(
                    restrict_block(mesh, f, c, r), c.counts),
                lambda xc, f=bl, c=coarse: prolong_block(mesh, c, f, xc,
                                                         full=True)))
    tail = _lattice_levels(spaces[nd - direct:], nd - direct, op_factory,
                           free_mask=free_mask,
                           smoother_degree=smoother_degree,
                           lanczos_start=lanczos_start, dtype=dtype,
                           stats=stats, fine_space=fine_space)
    return ShardedGMG(levels, list(blocks),
                      GMG(tail, _coarse_inverse(tail[-1], dtype), dtype,
                          stats),
                      mesh, dtype, transfers, direct)


def build_gmg_flat(fine_space, op_factory, *, free_mask, n_comp: int = 1,
                   smoother_degree: int = 4, lanczos_start=None,
                   dtype=torch.float64, stats: dict | None = None) -> GMG:
    """Build a flat GMG hierarchy on a continuous space of any degree and
    dimension, uniform or locally refined, for a scalar (``n_comp = 1``) or component-major
    vector field.

    ``op_factory(space) -> (mv, diag)``: ``mv`` applies the level's
    unconstrained operator to flat vectors of ``n_comp·n`` entries in the
    cycle precision, ``diag`` is its assembled diagonal (float64 NumPy or a
    tensor, flat).  The level operator is the Dirichlet-masked
    ``m*A(m*x) + (1-m)*x``; ``free_mask`` is the fine mask (bool tensor of
    ``n_comp·n``), coarse masks hold the same faces fixed in every
    component.  ``lanczos_start(level_index, n) -> ndarray`` optionally
    supplies each level's Lanczos start vector (``n = n_comp·n_level``).
    ``dtype`` is the cycle precision, as in :func:`build_gmg`."""
    levels = _flat_levels(level_spaces(fine_space), 0, op_factory,
                          free_mask=free_mask, n_comp=n_comp,
                          smoother_degree=smoother_degree,
                          lanczos_start=lanczos_start, dtype=dtype,
                          stats=stats)
    return GMG(levels, _coarse_inverse(levels[-1], dtype), dtype, stats)


def _flat_levels(spaces, first, op_factory, *, free_mask, n_comp,
                 smoother_degree, lanczos_start, dtype, stats,
                 fine_space=None):
    """The :class:`_Level` list of the flat levels ``spaces``, the first of
    which is level ``first`` of the hierarchy of ``fine_space`` (default
    ``spaces[0]``); the first one has no transfer."""
    device = free_mask.device
    level_mask = _level_masks(fine_space or spaces[0], free_mask, n_comp)
    levels = []
    for j, sp in enumerate(spaces):
        i = first + j
        n = n_comp * sp.n_dofs
        mask = torch.as_tensor(level_mask(sp, i), device=device)
        mv_raw, diag = op_factory(sp)

        def op(x, mv_raw=mv_raw, mask=mask):
            return torch.where(mask, mv_raw(torch.where(mask, x, 0.0)), x)

        prolong = None
        if j > 0:
            prolong = make_prolongation(spaces[j - 1], sp, device=device,
                                        dtype=dtype)
            if n_comp > 1:
                prolong = VectorProlongation(prolong, n_comp)
        levels.append(_level(
            i, sp, n, slice(0, n), mask, op, diag, None, prolong,
            smoother_degree=smoother_degree, lanczos_start=lanczos_start,
            dtype=dtype, stats=stats))
    return levels


def build_gmg_flat_sharded(fine_space, block_factory, op_factory, *, mesh,
                           blocks, free_mask, smoother_degree: int = 4,
                           lanczos_start=None, dtype=torch.float64,
                           stats: dict | None = None) -> ShardedGMG:
    """:func:`build_gmg_flat` (a scalar field) over contiguous ranges of
    the level vectors: the first ``len(blocks)`` levels are distributed
    (``blocks[i]``, ``parallel.mesh.plan_ranges``), the rest is the
    replicated tail built as :func:`build_gmg_flat` builds a hierarchy.

    ``block_factory(i, space, blocks_i) -> (mv, diag)`` gives a distributed
    level: ``mv(x)`` this rank's rows of the level's unconstrained operator
    applied to the whole level vector ``x``, ``diag`` the whole assembled
    diagonal; ``op_factory`` gives a tail level, as for
    :func:`build_gmg_flat`.  Every sharded operator all-gathers its input
    and applies the Dirichlet mask to the whole vector; the transfers
    (:class:`ProlongationRows`) all-gather theirs, and the last distributed
    level's restriction gives the whole first tail level.  Smoothers are the
    unfused Chebyshev; the Lanczos bounds as in :func:`build_gmg_sharded`."""
    spaces = level_spaces(fine_space)
    level_mask = _level_masks(fine_space, free_mask)
    device = free_mask.device
    nd = len(blocks)
    direct = nd == len(spaces)
    levels, transfers = [], []
    for i, (sp, bl) in enumerate(zip(spaces, blocks)):
        lo, hi = bl.rows(mesh.rank)
        m_full = torch.as_tensor(level_mask(sp, i), device=device)
        m_own = m_full[lo:hi]
        mv_own, diag = block_factory(i, sp, bl)

        def op(x, mv_own=mv_own, m_full=m_full, m_own=m_own, bl=bl):
            x_full = mesh.all_gather_rows(x, bl.counts)
            return torch.where(m_own, mv_own(torch.where(m_full, x_full,
                                                         0.0)), x)

        levels.append(_level(
            i, sp, sp.n_dofs, slice(lo, hi), m_own, op, diag,
            smoother_degree=smoother_degree, lanczos_start=lanczos_start,
            dtype=dtype, stats=stats, inner=inner_product(mesh)))
        if direct:
            transfers.append((
                lambda r, f=bl: mesh.all_gather_rows(r, f.counts),
                lambda x, lo=lo, hi=hi: x[lo:hi]))
            continue
        P = make_prolongation(sp, spaces[i + 1], device=device, dtype=dtype)
        fine_rows = ProlongationRows(P, lo, hi)
        if i + 1 < nd:
            coarse = blocks[i + 1]
            coarse_rows = ProlongationRows(P, *coarse.rows(mesh.rank),
                                           restrict=True)
            transfers.append((
                lambda r, f=bl, cr=coarse_rows: cr.rmv(
                    mesh.all_gather_rows(r, f.counts)),
                lambda xc, c=coarse, fr=fine_rows: fr.mv(
                    mesh.all_gather_rows(xc, c.counts))))
        else:
            transfers.append((
                lambda r, f=bl, P=P: P.rmv(mesh.all_gather_rows(r, f.counts)),
                fine_rows.mv))
    tail = _flat_levels(spaces[nd - direct:], nd - direct, op_factory,
                        free_mask=free_mask, n_comp=1,
                        smoother_degree=smoother_degree,
                        lanczos_start=lanczos_start, dtype=dtype,
                        stats=stats, fine_space=fine_space)
    return ShardedGMG(levels, list(blocks),
                      GMG(tail, _coarse_inverse(tail[-1], dtype), dtype,
                          stats),
                      mesh, dtype, transfers, direct)
