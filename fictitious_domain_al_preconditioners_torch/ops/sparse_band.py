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

import numpy as np
import torch

from .linop import LinOp
from .sparse import COO

__all__ = ["lattice_band_linop"]


def lattice_band_linop(space, coo: COO, *, scale: float = 1.0,
                       max_band: int = 4, n_comp: int = 1,
                       max_planes: int = 512, device="cuda",
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
