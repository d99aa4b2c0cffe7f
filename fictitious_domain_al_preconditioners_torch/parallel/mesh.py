"""Ranks, the row-block partition of the background lattice, and the sharded
solve steps.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.parallel.mesh``.
The JAX package block-partitions the lattice over a near-square 2D device
mesh ('x', 'y') and lets GSPMD insert the halo exchanges.  PyTorch has no
GSPMD, so the port partitions explicitly, and differently: the lattice is
cut into **row blocks** over lattice axis 0 (the slowest coordinate; a
block of whole rows is one contiguous piece of the flat dof vector), one
block a ``torch.distributed`` rank, and :func:`make_mesh` returns that
one-axis layout (:class:`Mesh`) instead of a 2D grid.  Whole rows keep every
column edge physical, so the kernels need no column halos; the immersed
side (multiplier vectors, the coupling's quadrature table) is replicated:
a replicated tensor is a plain tensor, whole on every rank
(:func:`replicated`).

A kernel runs on an *extended* block: this rank's rows plus ``depth`` halo
rows either side, from the blocks that hold them (:meth:`Mesh.exchange_halo`,
one exchange a kernel call).  The kernels' masks are index-based, so the extended block's first
and last rows act as Dirichlet rows; their values are wrong, and the wrong
values move one row inwards with every operator application.  The owned
rows are right when the halo is at least the depth of :data:`HALO` (or
:func:`sweep_halo` for a Chebyshev sweep); ``tests/test_torch_parallel.py``
checks each depth, and one row less.

The element form has no lattice rows: each level's flat dof vector is cut
into contiguous ranges (:func:`range_partition`, :func:`plan_ranges`;
:class:`RowBlocks` of one-entry rows), and its operators all-gather their
input (:meth:`Mesh.all_gather_rows`).

Transports (:attr:`Mesh.transport`): ``nccl`` sends device tensors (one card
a rank); ``gloo`` sends CPU tensors; ``gloo-host`` is gloo with CUDA tensors
(several ranks on one card, which NCCL refuses): halo rows and reduced
values are copied to the host, sent, and copied back.  The transport
follows from the backend and the device, and nothing falls back to another.
Under gloo a bfloat16 tensor travels in float32 (exact both ways; gloo
builds differ in their bfloat16 support).

:func:`launch` starts the ranks (spawned processes meeting through a file
store in a temporary directory) and returns their results.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .lattice import LatticeOps, _prolong_axis, _restrict_axis

__all__ = ["HALO", "sweep_halo", "Mesh", "make_mesh", "padded_shape",
           "RowBlocks", "row_partition", "plan_levels", "FLAT_MIN_ROWS",
           "range_partition", "plan_ranges", "lattice_sharding",
           "replicated", "inner_product", "restrict_block", "prolong_block",
           "on_block", "ext_rows", "block_laplace", "launch",
           "sharded_al_cg_step", "sharded_two_level_step"]

#: halo rows a call needs on an extended block: the unconstrained stiffness
#: (K6, ``LatticeOps.laplace``), one masked augmented apply (K1, K2 ``op``:
#: one row plus the row the mask zeroes) and a grid transfer
HALO = {"laplace": 1, "op": 2, "transfer": 1}


def sweep_halo(degree: int) -> int:
    """Halo rows of K2's ``pre``/``post`` of a degree-``degree`` Chebyshev
    sweep: ``degree`` operator applications, plus the row the mask
    zeroes."""
    return degree + 1


_COUNTS = ("halo_exchanges", "halo_bytes", "all_reduces", "all_gathers")


@dataclass
class Mesh:
    """This process's place among the ranks: ``rank`` of ``size``, the
    process group (``None``: the default group, or no group when ``size``
    is 1), its ``backend`` (``"gloo"``, ``"nccl"`` or ``None``) and the
    ``device`` its tensors live on.  ``counts`` counts the collectives since
    :meth:`reset_counts` (halo bytes are the bytes received)."""

    rank: int
    size: int
    backend: str | None
    device: torch.device
    group: object = None
    counts: dict = field(default_factory=lambda: dict.fromkeys(_COUNTS, 0))

    @property
    def transport(self) -> str:
        if self.size == 1:
            return "none"
        if self.backend == "nccl":
            return "nccl"
        return "gloo-host" if self.device.type == "cuda" else "gloo"

    def reset_counts(self):
        for k in self.counts:
            self.counts[k] = 0

    def _out(self, t):
        """``t`` as the transport sends it: on the host under gloo-host,
        and a bfloat16 tensor in float32 under gloo (exact both ways,
        whatever bfloat16 support the gloo build has; :meth:`_in` rounds
        it back)."""
        t = t.cpu() if self.transport == "gloo-host" else t.contiguous()
        if t.dtype == torch.bfloat16 and self.backend != "nccl":
            return t.float()
        return t

    @staticmethod
    def _in(buf, like):
        """A received ``buf`` as a tensor of ``like``'s dtype and device."""
        return buf.to(like.device, like.dtype)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor; ``t`` itself when
        there is one rank).  A bfloat16 ``t`` is summed in float32 under
        gloo and rounded back once (exact where one rank contributes each
        entry, as a compact AL block's band does)."""
        if self.size == 1:
            return t
        buf = self._out(t).clone()
        dist.all_reduce(buf, group=self.group)
        self.counts["all_reduces"] += 1
        return self._in(buf, t)

    def all_gather_rows(self, x: torch.Tensor, counts) -> torch.Tensor:
        """The rows of every rank's ``x`` (``counts[r]`` rows on rank r), in
        rank order, on every rank."""
        if self.size == 1:
            return x
        m = max(counts)
        out = self._out(x)
        buf = out.new_zeros((m,) + tuple(x.shape[1:]))
        buf[:x.shape[0]] = out
        bufs = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(bufs, buf, group=self.group)
        self.counts["all_gathers"] += 1
        return self._in(torch.cat([b[:c] for b, c in zip(bufs, counts)]), x)

    def same_on_every_rank(self, values, what: str):
        """Raise unless the float64 ``values`` are bit-equal on every
        rank."""
        if self.size == 1:
            return
        mine = torch.as_tensor(np.asarray(values, dtype=np.float64),
                               device=self.device if self.transport == "nccl"
                               else "cpu")
        got = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(got, mine, group=self.group)
        if not all(torch.equal(g, mine) for g in got):
            raise RuntimeError(f"{what} differs between ranks: "
                               f"{[g.tolist() for g in got]}")

    def exchange_halo(self, x: torch.Tensor, depth: int,
                      blocks: "RowBlocks"):
        """The extended block ``(ext, below, above)``: ``x`` (this rank's
        rows of ``blocks``) with the ``depth`` rows either side of it, from
        the blocks that hold them (the next one, or several when a block
        is thinner than ``depth``); ``below``/``above`` are the rows added
        (fewer at a lattice edge).  One exchange: every rank sends and
        receives at once."""
        lo, hi = blocks.rows(self.rank)
        a, b = ext_rows(self, blocks, depth)
        if (a, b) == (lo, hi):
            return x, 0, 0
        ops, recv = [], []
        staged = "cpu" if self.transport == "gloo-host" else x.device
        wire = self._out(x[:0]).dtype
        for q in range(self.size):
            if q == self.rank:
                continue
            qlo, qhi = blocks.rows(q)
            qa, qb = ext_rows(self, blocks, depth, q)
            for s, e in ((a, lo), (hi, b)):          # rows q sends me
                s, e = max(s, qlo), min(e, qhi)
                if s < e:
                    recv.append((s, torch.empty(
                        (e - s,) + tuple(x.shape[1:]), dtype=wire,
                        device=staged)))
                    ops.append(dist.P2POp(dist.irecv, recv[-1][1], q,
                                          self.group))
            for s, e in ((qa, qlo), (qhi, qb)):      # rows I send q
                s, e = max(s, lo), min(e, hi)
                if s < e:
                    ops.append(dist.P2POp(dist.isend,
                                          self._out(x[s - lo:e - lo]), q,
                                          self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        ext = x.new_empty((b - a,) + tuple(x.shape[1:]))
        ext[lo - a:hi - a] = x
        for s, buf in recv:
            ext[s - a:s - a + buf.shape[0]] = self._in(buf, x)
        self.counts["halo_exchanges"] += 1
        self.counts["halo_bytes"] += sum(t.numel() * t.element_size()
                                         for _, t in recv)
        return ext, lo - a, b - hi


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.get_backend()
    return 0, 1, None


def make_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """The one-axis mesh of the ranks of the default process group (one
    rank, no group, when none is initialized).

    Raises when fewer ranks are visible than ``n_devices`` (a silent
    truncation is what crashed the JAX package's first multichip dryrun),
    when ``n_devices`` is not every rank, and with ``nccl`` when fewer cards
    are visible than ranks.  ``device`` defaults to this rank's card
    (``cuda:rank`` under ``nccl``, the current card otherwise)."""
    rank, size, backend = _world()
    n = n_devices or size
    if n > size:
        raise RuntimeError(
            f"make_mesh: {n} ranks requested but only {size} visible "
            f"(backend {backend}); start them with parallel.mesh.launch "
            "or torch.distributed.init_process_group")
    if n < size:
        raise RuntimeError(f"make_mesh: a mesh spans every rank ({size}), "
                           f"not {n}")
    if backend == "nccl" and torch.cuda.device_count() < size:
        raise RuntimeError(
            f"make_mesh: nccl needs one card a rank: {size} ranks, "
            f"{torch.cuda.device_count()} cards visible")
    if device is None:
        device = torch.device("cuda", rank if backend == "nccl"
                              else torch.cuda.current_device())
    return Mesh(rank, size, backend, torch.device(device))


def padded_shape(shape: tuple, mesh: Mesh) -> tuple:
    """Round a dof-order lattice shape up so that the lattice's rows (its
    last, slowest dof axis) divide among the mesh's ranks."""
    out = list(shape)
    out[-1] = -(-shape[-1] // mesh.size) * mesh.size
    return tuple(out)


@dataclass(frozen=True)
class RowBlocks:
    """Rows ``[starts[r], starts[r+1])`` of an (ny, nx) lattice are rank
    r's."""

    starts: tuple
    nx: int

    @property
    def ny(self) -> int:
        return self.starts[-1]

    @property
    def counts(self) -> list:
        return [b - a for a, b in zip(self.starts[:-1], self.starts[1:])]

    def rows(self, rank: int) -> tuple:
        return self.starts[rank], self.starts[rank + 1]

    def coarse(self) -> "RowBlocks":
        """The blocks of the 2:1 coarser lattice: coarse row i goes with
        fine row 2i, so an even fine edge e becomes e/2 (nested blocks)."""
        ny_c = (self.ny - 1) // 2 + 1
        return RowBlocks(tuple((s + 1) // 2 for s in self.starts[:-1])
                         + (ny_c,), (self.nx - 1) // 2 + 1)


def row_partition(ny: int, nx: int, size: int, align: int = 0) -> RowBlocks:
    """Near-even row blocks of an (ny, nx) lattice over ``size`` ranks with
    every inner edge a multiple of ``2**align``, so that ``align``
    coarsenings keep whole, nested blocks."""
    step = 2 ** align
    ny_a = (ny - 1) // step + 1
    edges = [int(round(p * ny_a / size)) * step for p in range(size)]
    return RowBlocks(tuple(edges) + (ny,), nx)


def plan_levels(ny: int, nx: int, size: int, *, n_levels: int,
                depth: int) -> list:
    """The row blocks of the distributed levels of a 2:1 hierarchy, fine
    first; the rest of the hierarchy, at least its coarsest level, is the
    replicated tail.  The fine level is always distributed (a block thinner
    than a halo takes it from several blocks; a one-level hierarchy's too);
    a coarser one, never the coarsest, while all its blocks have at least
    ``depth`` rows.  The fine edges are multiples of ``2**(levels - 1)``, so
    the blocks nest."""
    if ny < size:
        raise ValueError(f"{ny} rows do not divide among {size} ranks")
    if n_levels == 1:
        return [row_partition(ny, nx, size)]
    for nd in range(n_levels - 1, 0, -1):
        levels = [row_partition(ny, nx, size, align=nd - 1)]
        for _ in range(nd - 1):
            levels.append(levels[-1].coarse())
        if min(levels[0].counts) > 0 and all(
                min(b.counts) >= depth for b in levels[1:]):
            return levels
    raise ValueError(f"no level of a {n_levels}-level hierarchy can be "
                     "distributed")


#: a level of the element form below the fine one is distributed while
#: every rank's range of its dofs holds at least this many (the coarser
#: ones form the replicated tail, whose last level keeps the dense coarse
#: inverse)
FLAT_MIN_ROWS = 128


def range_partition(n: int, size: int) -> RowBlocks:
    """Near-even contiguous ranges of a flat vector of ``n`` entries over
    ``size`` ranks: :class:`RowBlocks` of one-entry rows (``nx = 1``), the
    partition GSPMD's ``P(axes)`` gives the JAX package's flat vectors."""
    if n < size:
        raise ValueError(f"{n} dofs do not divide among {size} ranks")
    return RowBlocks(tuple(int(round(p * n / size)) for p in range(size))
                     + (n,), 1)


def plan_ranges(sizes, size: int) -> list:
    """The ranges (:func:`range_partition`) of the distributed levels of a
    flat hierarchy whose level vectors have ``sizes`` entries, fine first:
    the fine level always (a one-level hierarchy's too), a coarser one
    while ``size`` ranges of it hold at least :data:`FLAT_MIN_ROWS` entries
    each, never the coarsest."""
    out = [range_partition(sizes[0], size)]
    for n in sizes[1:-1]:
        if n // size < FLAT_MIN_ROWS:
            break
        out.append(range_partition(n, size))
    return out


class LatticeSharding:
    """Row blocks of lattice tensors over a mesh (the port's form of the
    JAX package's ``NamedSharding(mesh, P('x', 'y'))``; the blocks
    themselves are :func:`row_partition`'s)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def shard(self, x: torch.Tensor, blocks: RowBlocks) -> torch.Tensor:
        """This rank's rows of a global lattice tensor, on the mesh's
        device."""
        lo, hi = blocks.rows(self.mesh.rank)
        return x[lo:hi].to(self.mesh.device).contiguous()

    def gather(self, x: torch.Tensor, blocks: RowBlocks) -> torch.Tensor:
        return self.mesh.all_gather_rows(x, blocks.counts)


def lattice_sharding(mesh: Mesh) -> LatticeSharding:
    """Row blocks of the lattice over the mesh's ranks."""
    return LatticeSharding(mesh)


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank (the JAX package's ``NamedSharding(mesh,
    P())``): a replicated tensor is a plain tensor on the mesh's device."""
    return x.to(mesh.device)


def inner_product(mesh: Mesh, n_sharded: int | None = None):
    """The ``inner`` of ``ops.krylov`` for vectors whose first
    ``n_sharded`` entries (all by default) are this rank's block of a
    sharded vector and the rest replicated: the sharded part is all-reduced
    over the ranks and the replicated part added once (on one rank, the
    plain product)."""

    def inner(a, b):
        prod = torch.dot if a.dim() == 1 else torch.mv
        if mesh.size == 1:          # the serial product, in its order
            return prod(a, b)
        n = b.shape[0] if n_sharded is None else n_sharded
        out = mesh.all_reduce(prod(a[..., :n], b[:n]))
        return out if n == b.shape[0] else out + prod(a[..., n:], b[n:])

    return inner


def on_block(mesh: Mesh, blocks: RowBlocks, depth: int, fn, *xs):
    """``fn`` on the extended blocks of ``xs`` (this rank's rows of level
    tensors, each exchanged at ``depth``); returns the owned rows of its
    output (or of each output of a tuple)."""
    exts = [mesh.exchange_halo(x, depth, blocks) for x in xs]
    below, n = exts[0][1], xs[0].shape[0]
    out = fn(*(e[0] for e in exts))
    if isinstance(out, tuple):
        return tuple(o[below:below + n] for o in out)
    return out[below:below + n]


def ext_rows(mesh: Mesh, blocks: RowBlocks, depth: int,
             rank: int | None = None) -> tuple:
    """The lattice rows ``[a, b)`` of a rank's block (this rank's by
    default) extended by ``depth`` rows either side, within the
    lattice."""
    lo, hi = blocks.rows(mesh.rank if rank is None else rank)
    return max(lo - depth, 0), min(hi + depth, blocks.ny)


def restrict_block(mesh: Mesh, fine: RowBlocks, coarse: RowBlocks, r):
    """This rank's rows of ``lattice_restrict`` of a level tensor given by
    its owned rows (coarse row i from fine rows 2i-1 .. 2i+1: one halo
    row); bit-equal to the global restriction's rows."""
    ext, below, _ = mesh.exchange_halo(r, HALO["transfer"], fine)
    s = fine.rows(mesh.rank)[0] - below
    clo, chi = coarse.rows(mesh.rank)
    z = torch.zeros_like(ext[:1])
    ez = torch.cat([z, ext, z])           # row k is fine row s - 1 + k
    k, a = chi - clo, 2 * clo - s
    rows = ez[a + 1:a + 1 + 2 * k:2] + 0.5 * (ez[a:a + 2 * k:2]
                                             + ez[a + 2:a + 2 + 2 * k:2])
    return _restrict_axis(rows, 1).contiguous()


def prolong_block(mesh: Mesh, coarse: RowBlocks, fine: RowBlocks, xc,
                  full: bool = False):
    """This rank's rows of ``lattice_prolong`` of a coarse tensor given by
    its owned rows (one halo row), or with ``full`` by the whole coarse
    lattice; bit-equal to the global prolongation's rows."""
    if full:
        ext, t = xc, 0
    else:
        ext, below, _ = mesh.exchange_halo(xc, HALO["transfer"], coarse)
        t = coarse.rows(mesh.rank)[0] - below
    lo, hi = fine.rows(mesh.rank)
    c0 = lo // 2                          # coarse rows c0 .. hi // 2
    up = _prolong_axis(ext[c0 - t:hi // 2 - t + 1], 0)
    return _prolong_axis(up[lo - 2 * c0:hi - 2 * c0], 1).contiguous()


def block_laplace(mesh: Mesh, blocks: RowBlocks, h, x):
    """This rank's rows of the unconstrained stiffness ``LatticeOps.laplace``
    (K6 on CUDA) of a level tensor given by its owned rows."""
    def lap(ext):
        return LatticeOps(h, tuple(ext.shape)).laplace(ext)

    return on_block(mesh, blocks, HALO["laplace"], lap, x)


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

def _rank_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return dev


def _rank_main(rank, n, backend, device, store_path, out_dir, fn, args):
    payload = None
    try:
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n,
                                device_id=dev if backend == "nccl" else None)
        mesh = make_mesh(n, device=dev)
        if backend == "nccl":
            dist.barrier()     # the communicator exists before any P2P op
        payload = ("ok", fn(mesh, *args))
    except BaseException:   # the parent re-raises it with the traceback
        payload = ("error", traceback.format_exc())
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.tmp"), "wb") as fh:
            pickle.dump(payload, fh)
        os.replace(os.path.join(out_dir, f"rank{rank}.tmp"),
                   os.path.join(out_dir, f"rank{rank}.pkl"))
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, n: int, *, backend: str = "gloo", device="cpu", args=(),
           timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, spawned processes that meet
    through a file store in a temporary directory, and return their
    results in rank order.  ``fn`` must be importable by name (a module's
    function) and its results picklable.  ``device`` ``"cuda"`` puts rank r
    on card ``r % cards``.  A rank's exception is raised here with its
    traceback, the other ranks stopped; so are ranks still running after
    ``timeout`` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="fdal_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, n, backend, str(device), store, tmp, fn, tuple(args)))
            for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, {}
        deadline, grace = time.monotonic() + timeout, None
        try:
            while len(results) + len(errors) < n:
                for r, p in enumerate(procs):
                    if r in results or r in errors:
                        continue
                    path = os.path.join(tmp, f"rank{r}.pkl")
                    died = p.exitcode is not None
                    if os.path.exists(path):
                        with open(path, "rb") as fh:
                            status, value = pickle.load(fh)
                        (results if status == "ok" else errors)[r] = value
                    elif died:
                        errors[r] = f"died with exit code {p.exitcode}"
                now = time.monotonic()
                if errors and grace is None:
                    grace = now + 5.0   # the others' failures, if any
                if (grace is not None and now > grace) or now > deadline:
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                p.join(timeout=10 if len(results) == n else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(f"rank {r} of {n} failed:\n{errors[r]}"
                                     for r in sorted(errors)))
    if len(results) < n:
        raise TimeoutError(f"{n} ranks did not finish within {timeout} s")
    return [results[r] for r in range(n)]


# ---------------------------------------------------------------------------
# the sharded solve steps of the JAX package
# ---------------------------------------------------------------------------

def _cg_steps(apply, b, n_cg, inner, precond=None):
    """``n_cg`` CG steps from 0 with plain sums, as the JAX steps write
    them (no stopping test)."""
    x = torch.zeros_like(b)
    r = b
    z = r if precond is None else precond(r)
    p = z
    rz = inner(r.reshape(-1), z.reshape(-1))
    for _ in range(n_cg):
        Ap = apply(p)
        alpha = rz / inner(p.reshape(-1), Ap.reshape(-1))
        x = x + alpha * p
        r = r - alpha * Ap
        z = r if precond is None else precond(r)
        rz_new = inner(r.reshape(-1), z.reshape(-1))
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def sharded_al_cg_step(mesh: Mesh, lattice_ops: LatticeOps, coupling,
                       gamma: float, n_cg: int = 5):
    """``n_cg`` CG iterations on ``Aug u = (K + γ·Σ_q φφᵀ JxW) u`` over the
    row blocks: ``step(b_lattice) -> x_lattice`` on global (padded) lattice
    tensors.  The stiffness runs on each block with one halo row; the
    particle term's quadrature values are summed over the ranks (each adds
    its own dofs' share) and scattered into each rank's rows, the immersed
    table replicated."""
    ny, nx = lattice_ops.shape
    shard = lattice_sharding(mesh)
    blocks = row_partition(ny, nx, mesh.size)
    lo, hi = blocks.rows(mesh.rank)
    table = coupling.row_block(lo, hi, nx).to(mesh.device, coupling.dtype)
    inner = inner_product(mesh)

    def aug_apply(u):
        ku = block_laplace(mesh, blocks, lattice_ops.h, u)
        flat = u.reshape(-1)
        vals = mesh.all_reduce(table.interp_bg(flat)) * table.jxw
        al = torch.zeros_like(flat).index_add_(
            0, table.bg_dofs.reshape(-1),
            (table.bg_phi * vals[:, None]).reshape(-1))
        return ku + gamma * al.reshape(u.shape)

    def step(b):
        b_own = shard.shard(lattice_ops.unpad(b), blocks)
        x = _cg_steps(aug_apply, b_own, n_cg, inner)
        return lattice_ops.pad(shard.gather(x, blocks))

    return step


def sharded_two_level_step(mesh: Mesh, fine_ops: LatticeOps,
                           coarse_ops: LatticeOps, n_cg: int = 3,
                           jacobi_diag=None):
    """A two-level (fine/coarse) V-cycle-preconditioned CG step on the
    lattice Poisson operator over nested row blocks: damped Jacobi pre- and
    post-smoothing, the restricted residual, 10 Jacobi sweeps on the
    coarse level, the prolonged correction; every stencil and transfer on
    the blocks with one halo row.  ``fine_ops``/``coarse_ops`` are
    LatticeOps (coarse = fine coarsened once, unpadded).  Returns
    ``step(b_fine_lattice) -> x`` on global lattice tensors."""
    ny, nx = fine_ops.shape
    shard = lattice_sharding(mesh)
    fine = row_partition(ny, nx, mesh.size, align=1)
    coarse = fine.coarse()
    dinv = jacobi_diag
    inner = inner_product(mesh)
    w_c = 0.6 / (4.0 / coarse_ops.h[0])

    def vcycle(r):
        x = 0.6 * dinv * r
        rc = restrict_block(mesh, fine, coarse,
                            r - block_laplace(mesh, fine, fine_ops.h, x))
        xc = torch.zeros_like(rc)
        for _ in range(10):
            xc = xc + w_c * (rc - block_laplace(mesh, coarse, coarse_ops.h,
                                                xc))
        x = x + prolong_block(mesh, coarse, fine, xc)
        return x + 0.6 * dinv * (r - block_laplace(mesh, fine, fine_ops.h,
                                                   x))

    def step(b):
        b_own = shard.shard(b, fine)
        x = _cg_steps(lambda p: block_laplace(mesh, fine, fine_ops.h, p),
                      b_own, n_cg, inner, precond=vcycle)
        return shard.gather(x, fine)

    return step
