"""Banded lattice applies: sparse lattice-space operators as weight planes.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.sparse_band``.
Any operator assembled on a continuous ``GridSpace`` couples dofs within a
fixed lattice distance (the FE support width; γ·Cᵀdiag(w)C inherits the
coupling's), so its matrix is a variable-coefficient stencil: per lattice
offset one weight plane on the bounding patch of its rows.  The apply takes
every shifted window of the patch as one strided view of the lattice tensor,
multiplies it by the planes and sums over the offsets, then assigns the
patch into the output: three kernels whatever the number of planes, no
gather, no scatter.  The reference
feeds its AMG the same explicit diag-weighted matrices
(elliptic_interface.cc:821-851, utilities.h:111-331); here they are the GMG
level operators' AL terms.

Supports any dimension, any continuous degree (the band grows with the FE
support), and component-major vector operators (``n_comp`` blocks, e.g. the
elasticity or Stokes velocity stiffness with cross-component coupling).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .coupling import VectorCoupling
from .linop import LinOp
from .sparse import COO, spgemm_ctwc

__all__ = ["MAX_BAND", "MAX_PLANES", "al_reach", "band_plane_keys",
           "band_plane_keys_lower_bound", "lattice_band_linop",
           "vector_al_level"]

# the band stencil's caps on its half-width and weight planes
MAX_BAND = 4
MAX_PLANES = 512


def lattice_band_linop(space, coo: COO, *, scale: float = 1.0,
                       max_band: int = MAX_BAND, n_comp: int = 1,
                       max_planes: int = MAX_PLANES, device="cuda",
                       dtype=torch.float64):
    """Exact banded apply of ``scale * coo`` on a lattice space.

    ``space`` must be a continuous :class:`GridSpace`-like object with
    ``n_points_1d`` (lattice numbering, x fastest); ``coo`` is the
    (``n_comp``·n × ``n_comp``·n) operator in component-major dof order.
    The weight planes are held on ``device`` in ``dtype``.

    Returns ``(mv_flat: LinOp, mv_lat: ((ny,nx)->(ny,nx)) | None,
    diag: (n_comp·n,) np.ndarray)`` — ``mv_lat`` only for scalar 2D — or
    ``None`` when the space is not a lattice, the band exceeds ``max_band``,
    or the stencil needs more than ``max_planes`` weight planes (callers
    fall back to their generic applies)."""
    if (space is None or not getattr(space, "continuous", False)
            or not hasattr(space, "n_points_1d")):
        return None
    if coo.nnz == 0:
        return None
    npts = tuple(int(x) for x in space.n_points_1d)
    d = len(npts)
    lat_shape = tuple(reversed(npts))          # row-major: last axis = x
    n = int(np.prod(npts))
    assert coo.shape == (n_comp * n, n_comp * n)

    comp_i, li = coo.rows // n, coo.rows % n
    comp_j, lj = coo.cols // n, coo.cols % n

    def coords(flat):
        out = []
        rem = flat
        for k in range(d):                      # dim order, x first
            out.append(rem % npts[k])
            rem = rem // npts[k]
        return list(reversed(out))              # lattice-axis order

    ci = coords(li)
    cj = coords(lj)
    offs = [cj[a] - ci[a] for a in range(d)]
    B = [int(np.abs(o).max()) for o in offs]
    if max(B) > max_band:
        return None

    # shared bounding patch of the ROW support, all components
    lo = [int(c.min()) for c in ci]
    hi = [int(c.max()) for c in ci]
    psh = tuple(hi[a] - lo[a] + 1 for a in range(d))
    interior = all(lo[a] >= B[a] and hi[a] <= lat_shape[a] - 1 - B[a]
                   for a in range(d))

    # bin entries into per-(comp_i, comp_j, offset) weight planes
    kdims = tuple(2 * b + 1 for b in B)
    w = np.zeros((n_comp, n_comp) + kdims + psh)
    idx = (comp_i, comp_j) + tuple(offs[a] + B[a] for a in range(d)) + \
        tuple(ci[a] - lo[a] for a in range(d))
    np.add.at(w, idx, scale * coo.vals)

    # the planes of every offset (the empty ones stay zero) on the device;
    # too many non-empty ones and the caller's generic apply wins
    n_planes = int(np.count_nonzero(
        w.reshape(n_comp * n_comp * int(np.prod(kdims)), -1).any(axis=1)))
    if n_planes > max_planes:
        return None
    planes = torch.as_tensor(w, dtype=dtype, device=device)
    offset_dims = tuple(range(d))

    # the halo'd input of the patch: the patch grown by B on every side, a
    # slice of the input when interior, of the zero-padded input otherwise
    base = tuple(lo[a] - B[a] for a in range(d)) if interior \
        else tuple(lo[a] for a in range(d))
    halo = tuple(slice(base[a], base[a] + psh[a] + 2 * B[a])
                 for a in range(d))
    out_slice = tuple(slice(lo[k], hi[k] + 1) for k in range(d))
    pads = []
    for a in reversed(range(d)):                # F.pad: last axis first
        pads += [B[a], B[a]]

    def windows(c):
        """All shifted patch windows of lattice tensor ``c`` as one strided
        view (*kdims, *psh): window ``off`` is the patch moved by
        ``off - B``."""
        up = (c if interior else torch.nn.functional.pad(c, pads))[halo]
        for a in range(d):
            up = up.unfold(a, psh[a], 1)
        return up

    def comp_apply(comps):
        """comps: tuple of n_comp lattice tensors -> list of the same: per
        output component, the product of every plane with its window,
        summed over the offsets."""
        dt = comps[0].dtype
        pl = planes.to(dt)              # a no-op in the dtype built in
        wins = [windows(c) for c in comps]
        outs = []
        for a in range(n_comp):
            acc = None
            for b in range(n_comp):
                term = (pl[a, b] * wins[b]).sum(dim=offset_dims)
                acc = term if acc is None else acc + term
            o = torch.zeros(lat_shape, dtype=dt, device=comps[0].device)
            o[out_slice] = acc
            outs.append(o)
        return outs

    def mv(u):
        comps = tuple(u.reshape((n_comp,) + lat_shape)[k]
                      for k in range(n_comp))
        return torch.stack(comp_apply(comps)).reshape(u.shape)

    mv_lat = None
    if n_comp == 1 and d == 2:
        def mv_lat(x2d):             # noqa: F811 — scalar 2D lattice form
            return comp_apply((x2d,))[0]

    dg = np.zeros((n_comp,) + lat_shape)
    ctr = tuple(B)
    for a in range(n_comp):
        dg[a][out_slice] = w[(a, a) + ctr]
    nn = n_comp * n
    return (LinOp(mv, (nn, nn), mv, name="band_stencil"), mv_lat,
            dg.reshape(-1))


def band_plane_keys_lower_bound(fe, local, n_comp: int) -> set:
    """Weight planes that the band stencil of an operator assembled from the
    shared component-major local matrix ``local`` on a lattice of ``fe``
    needs at least, as keys ``(ci, cj) + offset`` (the offset column minus
    row along each lattice axis, x first).  For every lattice offset o there
    is a lattice corner node that lies in one cell only, in which the node o
    away is also a node; the assembled entry between them is the single
    local entry, so its plane is not empty when that entry is not zero (the
    AL term, zero at the lattice's corners, only adds planes)."""
    mi = fe.node_multi_indices
    k, nloc = fe.degree, len(mi)
    index = {tuple(int(x) for x in m): i for i, m in enumerate(mi)}
    keys = set()
    for o in itertools.product(range(-k, k + 1), repeat=mi.shape[1]):
        a = tuple(0 if x >= 0 else k for x in o)
        ia = index[a]
        ib = index[tuple(x + y for x, y in zip(a, o))]
        for ci in range(n_comp):
            for cj in range(n_comp):
                if local[ci * nloc + ia, cj * nloc + ib] != 0.0:
                    keys.add((ci, cj) + tuple(o))
    return keys


def al_reach(space, coupling) -> int:
    """Largest lattice-axis distance between two background dofs of
    ``space`` that share an immersed dof in the coupling table: the band
    half-width that γ·Cᵀdiag(w)C needs (every product of two positive
    entries is an entry), read from the table without forming the product."""
    h = coupling.host
    imm = np.asarray(h["imm_dofs"]).reshape(-1)
    per_qp = h["imm_dofs"].shape[1]
    idx = np.asarray(h["bg_dofs"], dtype=np.int64)
    reach = 0
    for m in space.n_points_1d:
        c = idx % m
        idx = idx // m
        lo = np.full(coupling.shape[0], np.iinfo(np.int64).max)
        hi = np.full(coupling.shape[0], -1)
        np.minimum.at(lo, imm, np.repeat(c.min(axis=1), per_qp))
        np.maximum.at(hi, imm, np.repeat(c.max(axis=1), per_qp))
        touched = hi >= 0
        reach = max(reach, int((hi - lo)[touched].max(initial=0)))
    return reach


def band_plane_keys(space, coo, n_comp) -> set:
    """The band's weight planes of a component-major COO on ``space``'s
    lattice, as keys ``(ci, cj) + offset`` (x first), its entries all
    within :data:`MAX_BAND` of their rows."""
    n = space.n_dofs
    ri, ci = coo.rows % n, coo.cols % n
    base = 2 * MAX_BAND + 1
    code = (coo.rows // n) * n_comp + coo.cols // n
    for m in space.n_points_1d:
        code = code * base + (ci % m - ri % m + MAX_BAND)
        ri, ci = ri // m, ci // m
    keys = set()
    for c in np.unique(code).tolist():
        offs = []
        for _ in space.n_points_1d:
            c, o = divmod(c, base)
            offs.append(o - MAX_BAND)
        ci_, cj_ = divmod(c, n_comp)
        keys.add((ci_, cj_) + tuple(reversed(offs)))
    return keys


def vector_al_level(space, A_l, local, n_comp: int, coupling=None,
                    w_diag=None, gamma: float = 0.0, *, device, dtype):
    """``(mv, diag, route)`` of a vector GMG level matrix
    ``A_l + γ·blockdiag(Cᵀdiag(w)C)`` (``A_l`` alone when ``coupling`` is
    None; the AL term is the scalar ``coupling``'s in every component).

    ``route`` is ``"band"`` when the whole matrix is one band stencil
    (:func:`lattice_band_linop`: no gather or scatter in the smoother; the
    reference's AMG consumes the same explicit matrices,
    utilities.h:111-331), else ``"element"``: the element-form ``A_l.mv``
    plus the coupling's applies.  The band is refused before the SpGEMM
    when the coupling reaches past its half-width (:func:`al_reach`), and
    before ``A_l``'s triplets are formed when ``A_l`` (from its shared
    local matrix ``local``) and the AL term together need more weight
    planes than it allows.  A space off the lattice (a locally refined
    one, ``local`` None) takes the element route."""
    lattice = local is not None
    keys = (band_plane_keys_lower_bound(space.fe, local, n_comp) if lattice
            else set())
    al = None
    if (lattice and coupling is not None
            and al_reach(space, coupling) <= MAX_BAND):
        ns = space.n_dofs
        al_s = spgemm_ctwc(COO.from_coupling(coupling), np.asarray(w_diag))
        al = COO(np.concatenate([al_s.rows + k * ns for k in range(n_comp)]),
                 np.concatenate([al_s.cols + k * ns for k in range(n_comp)]),
                 np.concatenate([al_s.vals] * n_comp), (ns * n_comp,) * 2)
        keys = keys | band_plane_keys(space, al, n_comp)
    if (lattice and (coupling is None or al is not None)
            and len(keys) <= MAX_PLANES):
        lvl = COO.from_cell_matrix(A_l)
        if al is not None:
            lvl = lvl.add(al, alpha=gamma)
        band = lattice_band_linop(space, lvl, n_comp=n_comp, device=device,
                                  dtype=dtype)
        if band is not None:
            return band[0], band[2], "band"
    diag = A_l.diag_host()
    if coupling is None:
        return A_l.mv, diag, "element"
    Cv = VectorCoupling(coupling.to(device, dtype), n_comp)
    wd = torch.as_tensor(w_diag, dtype=dtype, device=device)
    n_imm = coupling.shape[0]

    def mv(x):
        wl = (wd * Cv.mv(x).reshape(n_comp, n_imm)).reshape(-1)
        return A_l.mv(x) + gamma * Cv.rmv(wl)

    return mv, diag + Cv.al_term_diag(w_diag, gamma), "element"
