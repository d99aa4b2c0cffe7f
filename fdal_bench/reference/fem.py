"""Plain finite-element pieces of the reference: Gauss rules, Lagrange
bases on [0, 1], one-dimensional matrices on a uniform grid, the immersed
polygon and its quadrature.  NumPy in float64; nothing here imports the
program."""

from __future__ import annotations

import numpy as np

from .expr import evaluate


def gauss(n: int):
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def lagrange(degree: int, t):
    """Values and derivatives (len(t), degree + 1) of the Lagrange basis on
    [0, 1] with equispaced nodes, ordered by position."""
    t = np.asarray(t, dtype=np.float64)
    nodes = np.linspace(0.0, 1.0, degree + 1)
    val = np.ones((t.size, degree + 1))
    der = np.zeros((t.size, degree + 1))
    for a in range(degree + 1):
        others = [b for b in range(degree + 1) if b != a]
        den = np.prod([nodes[a] - nodes[b] for b in others])
        val[:, a] = np.prod([t - nodes[b] for b in others], axis=0) / den
        for skip in others:
            rest = [b for b in others if b != skip]
            der[:, a] += np.prod([t - nodes[b] for b in rest] or
                                 [np.ones_like(t)], axis=0) / den
    return val, der


def matrices_1d(n_cells: int, row_degree: int, col_degree: int,
                row_der: bool, col_der: bool, n_gauss: int = 4):
    """Dense global matrix ``∫ r_i c_j`` on [0, 1] cut into ``n_cells``
    equal cells, rows of degree ``row_degree`` (its derivative with
    ``row_der``), columns of ``col_degree`` (likewise), dofs by position."""
    h = 1.0 / n_cells
    t, w = gauss(n_gauss)
    rv, rd = lagrange(row_degree, t)
    cv, cd = lagrange(col_degree, t)
    r = rd / h if row_der else rv
    c = cd / h if col_der else cv
    local = (r * (w * h)[:, None]).T @ c
    out = np.zeros((n_cells * row_degree + 1, n_cells * col_degree + 1))
    for cell in range(n_cells):
        out[cell * row_degree:(cell + 1) * row_degree + 1,
            cell * col_degree:(cell + 1) * col_degree + 1] += local
    return out


class Polygon:
    """The immersed curve: [0, 1] cut into 2**refinement cells, its
    vertices mapped by the configuration's parametrization, straight
    segments between them (geometry degree 1), one P1 dof per vertex, the
    first and last apart (a closed curve is not made periodic)."""

    def __init__(self, expression: str, constants: str, refinement: int):
        n = 2 ** refinement
        s = np.linspace(0.0, 1.0, n + 1)
        pts = np.stack([s, np.zeros_like(s)], axis=1)
        self.vertices = np.asarray(evaluate(expression, constants, pts),
                                   dtype=np.float64)
        self.n_cells = n
        self.lengths = np.linalg.norm(np.diff(self.vertices, axis=0), axis=1)
        self.h_max = float(self.lengths.max())

    def quadrature(self, n_gauss: int):
        """Points (nc*nq, 2), the two P1 basis values (nc*nq, 2), the dofs
        they belong to (nc*nq, 2) and JxW (nc*nq,)."""
        t, w = gauss(n_gauss)
        a, b = self.vertices[:-1], self.vertices[1:]
        pts = a[:, None, :] * (1 - t)[None, :, None] + b[:, None, :] * t[None, :, None]
        psi = np.stack([1 - t, t], axis=1)                       # (nq, 2)
        cells = np.arange(self.n_cells)
        dofs = np.stack([cells, cells + 1], axis=1)              # (nc, 2)
        jxw = self.lengths[:, None] * w[None, :]
        nq = t.size
        return (pts.reshape(-1, 2), np.tile(psi, (self.n_cells, 1)),
                np.repeat(dofs, nq, axis=0), jxw.reshape(-1))

    def mass_diagonal(self):
        """Diagonal of the P1 mass matrix on the polygon."""
        d = np.zeros(self.n_cells + 1)
        d[:-1] += self.lengths / 3.0
        d[1:] += self.lengths / 3.0
        return d

    def load(self, values, psi, dofs, jxw):
        """``∫_Γ g ψ_i`` from ``values`` of g at the quadrature points
        (nq,) or (nq, k)."""
        values = np.asarray(values, dtype=np.float64)
        vals = values if values.ndim == 2 else values[:, None]
        out = np.zeros((self.n_cells + 1, vals.shape[1]))
        for a in range(2):
            np.add.at(out, dofs[:, a], (psi[:, a] * jxw)[:, None] * vals)
        return out if values.ndim == 2 else out[:, 0]


def lattice_basis(points, n_cells: int, degree: int):
    """Tensor-product Lagrange basis of a uniform lattice of ``n_cells``
    cells a side on [0, 1]², at ``points`` (np, 2): the flat lattice index
    (x fastest) and the value of each of the (degree + 1)² basis functions
    of the cell that holds the point, (np, (degree + 1)²) each."""
    h = 1.0 / n_cells
    q = points / h
    cell = np.clip(np.floor(q).astype(np.int64), 0, n_cells - 1)
    loc = q - cell
    vx, _ = lagrange(degree, loc[:, 0])
    vy, _ = lagrange(degree, loc[:, 1])
    side = n_cells * degree + 1
    idx, val = [], []
    for b in range(degree + 1):
        for a in range(degree + 1):
            idx.append((cell[:, 1] * degree + b) * side + cell[:, 0] * degree + a)
            val.append(vx[:, a] * vy[:, b])
    return np.stack(idx, axis=1), np.stack(val, axis=1)


def lattice_load(expression: str, constants: str, n_cells: int, degree: int,
                 n_gauss: int, n_comp: int, device):
    """``∫_Ω f φ_i`` on the uniform lattice of Q``degree``, one column a
    component (the torch tensor (side², n_comp), float64 on ``device``),
    with an ``n_gauss``² Gauss rule in each cell."""
    import torch

    h = 1.0 / n_cells
    t, w = gauss(n_gauss)
    val, _ = lagrange(degree, t)
    side = n_cells * degree + 1
    x1 = (np.arange(n_cells)[:, None] + t[None, :]).reshape(-1) * h
    tx = torch.as_tensor(x1, dtype=torch.float64, device=device)
    X = tx[None, :].expand(tx.numel(), tx.numel())
    Y = tx[:, None].expand(tx.numel(), tx.numel())
    f = evaluate(expression, constants, (X, Y))
    f = [f] if n_comp == 1 and not isinstance(f, (list, tuple)) else list(f)
    # weight and basis along one axis: (side, cells*gauss) scatter matrix
    S = np.zeros((side, n_cells * n_gauss))
    for c in range(n_cells):
        for a in range(degree + 1):
            S[c * degree + a, c * n_gauss:(c + 1) * n_gauss] += val[:, a] * w * h
    S = torch.as_tensor(S, dtype=torch.float64, device=device)
    cols = []
    for comp in f:
        comp = torch.as_tensor(comp, dtype=torch.float64, device=device)
        if comp.dim() == 0:
            comp = comp.expand(X.shape)
        cols.append((S @ comp @ S.T).reshape(-1))
    return torch.stack(cols, dim=1)
