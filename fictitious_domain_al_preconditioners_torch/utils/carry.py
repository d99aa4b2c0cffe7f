"""Setup state carried from the reference package into a port problem.

This system has no weights: what a parity run carries across is the setup
state of one problem (right-hand sides, Dirichlet data, the coupling table,
the immersed mass diagonal or the whole immersed mass and stiffness matrices,
and the GMG Lanczos start vectors), handed over as NumPy arrays so both
solvers run on identical inputs (a rank of the sharded solve keeps its
rows of the Lanczos vectors, :func:`block_lanczos_start`).  Five states:
the immersed_laplace problem's (:class:`CarriedState`), the elliptic
interface problem's (:class:`EllipticState`), the Stokes problem's
(:class:`StokesState`), the nitsche problem's (:class:`NitscheState`) and
the elasticity interface problem's (:class:`ElasticityState`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.coupling import Coupling
from ..ops.operators import CellMatrix

__all__ = ["CarriedState", "DiagonalMatrix", "ElasticityState",
           "EllipticState", "NitscheState", "StokesState", "block_lanczos_start",
           "gmg_level_sizes", "state_from_jax"]


def gmg_level_sizes(space, n_comp: int = 1) -> list:
    """Entries of every level vector of the flat GMG hierarchy on
    ``space``, fine level first: the sizes of the Lanczos start vectors to
    carry (``lanczos_starts``).  A locally refined space coarsens by
    truncating its tree (``precond.gmg.level_spaces``), so its sizes are
    not those of the uniform 2:1 hierarchy."""
    from ..precond.gmg import level_spaces

    return [n_comp * sp.n_dofs for sp in level_spaces(space)]


def block_lanczos_start(lanczos_start, level: int, n: int, lo: int, hi: int,
                        nx: int) -> np.ndarray:
    """Rows ``[lo, hi)`` (flat) of level ``level``'s Lanczos start vector on
    an ``nx``-column lattice of ``n`` dofs: the carried vector
    (``lanczos_start(level, n)``) or, without one, the draw every serial
    hierarchy makes (``default_rng(0).standard_normal(n)``).  A rank of the
    row-block sharded solve starts its block of the Lanczos vectors from
    this, so its bounds are the serial hierarchy's."""
    v0 = lanczos_start(level, n) if lanczos_start is not None else None
    if v0 is None:
        v0 = np.random.default_rng(0).standard_normal(n)
    return np.asarray(v0).reshape(-1, nx)[lo:hi].reshape(-1)


class DiagonalMatrix:
    """Stands in for the immersed mass matrix where only its assembled
    diagonal is carried (W = diag(M))."""

    def __init__(self, d: torch.Tensor):
        self._d = d

    def diag(self) -> torch.Tensor:
        return self._d


@dataclass
class CarriedState:
    rhs_f: torch.Tensor
    rhs_g: torch.Tensor
    bc_values: torch.Tensor
    free: torch.Tensor
    coupling: Coupling
    mass: DiagonalMatrix | CellMatrix
    stiffness: CellMatrix | None
    lanczos_starts: list | None


@dataclass
class EllipticState:
    rhs_f1: torch.Tensor
    rhs_f2: torch.Tensor
    bc_values: torch.Tensor
    free: torch.Tensor
    coupling: Coupling
    A1: CellMatrix
    A2: CellMatrix
    M: CellMatrix
    lanczos_starts: list | None
    lanczos_starts_a22: list | None


@dataclass
class StokesState:
    rhs_u: torch.Tensor
    rhs_g: torch.Tensor
    bc_values: torch.Tensor
    free: torch.Tensor
    coupling: Coupling          # the scalar table (velocity's scalar space)
    M_imm: CellMatrix           # scalar immersed mass
    Mp: CellMatrix              # pressure mass
    lanczos_starts: list | None


@dataclass
class NitscheState:
    rhs_f: torch.Tensor
    rhs_g: torch.Tensor
    coupling: Coupling          # with its quadrature points
    M: CellMatrix               # multiplier mass
    lanczos_starts: list | None


@dataclass
class ElasticityState:
    rhs_f1: torch.Tensor        # component-major
    rhs_f2: torch.Tensor
    free: torch.Tensor
    coupling: Coupling          # the scalar table
    M: CellMatrix               # scalar immersed mass
    lanczos_starts: list | None
    lanczos_starts_a22: list | None


_KEYS = ("rhs_f", "rhs_g", "bc_values", "free", "bg_dofs", "bg_phi",
         "imm_dofs", "imm_psi", "jxw", "m_diag")
_ELLIPTIC_KEYS = ("rhs_f1", "rhs_f2", "bc_values", "free", "bg_dofs",
                  "bg_phi", "imm_dofs", "imm_psi", "jxw", "a1_cell_dofs",
                  "a1_local", "imm_cell_dofs", "a2_local", "m_local")


_STOKES_KEYS = ("rhs_u", "rhs_g", "bc_values", "free", "bg_dofs", "bg_phi",
                "imm_dofs", "imm_psi", "jxw", "imm_cell_dofs", "m_local",
                "p_cell_dofs", "mp_local")


def _stokes_state(arrays: dict, device, dtype) -> StokesState:
    missing = [k for k in _STOKES_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"state_from_jax: missing arrays {missing}")

    def ten(key, dt=dtype):
        return torch.as_tensor(np.array(arrays[key]), dtype=dt,
                               device=device)

    def cell_matrix(dofs, local):
        d = np.asarray(arrays[dofs])
        n = int(d.max()) + 1
        return CellMatrix(d, d, np.asarray(arrays[local]), (n, n),
                          device=device, dtype=dtype)

    M_imm = cell_matrix("imm_cell_dofs", "m_local")
    bg_dofs = np.asarray(arrays["bg_dofs"])
    n_comp = len(np.asarray(arrays["rhs_g"])) // M_imm.shape[0]
    n_bg = len(np.asarray(arrays["rhs_u"])) // n_comp
    starts = arrays.get("lanczos_starts")
    return StokesState(
        rhs_u=ten("rhs_u"), rhs_g=ten("rhs_g"), bc_values=ten("bc_values"),
        free=ten("free", torch.bool),
        coupling=Coupling(bg_dofs, arrays["bg_phi"], arrays["imm_dofs"],
                          arrays["imm_psi"], arrays["jxw"],
                          (M_imm.shape[0], n_bg), device=device, dtype=dtype),
        M_imm=M_imm, Mp=cell_matrix("p_cell_dofs", "mp_local"),
        lanczos_starts=None if starts is None
        else [np.array(v) for v in starts])


def _elliptic_state(arrays: dict, device, dtype) -> EllipticState:
    missing = [k for k in _ELLIPTIC_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"state_from_jax: missing arrays {missing}")

    def ten(key, dt=dtype):
        return torch.as_tensor(np.array(arrays[key]), dtype=dt,
                               device=device)

    rhs_f1, rhs_f2 = ten("rhs_f1"), ten("rhs_f2")
    n, m = rhs_f1.shape[0], rhs_f2.shape[0]

    def cell_matrix(dofs, local, size):
        return CellMatrix(arrays[dofs], arrays[dofs], np.asarray(arrays[local]),
                          (size, size), device=device, dtype=dtype)

    def starts(key):
        v = arrays.get(key)
        return None if v is None else [np.array(x) for x in v]

    return EllipticState(
        rhs_f1=rhs_f1, rhs_f2=rhs_f2, bc_values=ten("bc_values"),
        free=ten("free", torch.bool),
        coupling=Coupling(arrays["bg_dofs"], arrays["bg_phi"],
                          arrays["imm_dofs"], arrays["imm_psi"],
                          arrays["jxw"], (m, n), device=device, dtype=dtype),
        A1=cell_matrix("a1_cell_dofs", "a1_local", n),
        A2=cell_matrix("imm_cell_dofs", "a2_local", m),
        M=cell_matrix("imm_cell_dofs", "m_local", m),
        lanczos_starts=starts("lanczos_starts"),
        lanczos_starts_a22=starts("lanczos_starts_a22"))


_NITSCHE_KEYS = ("rhs_f", "rhs_g", "bg_dofs", "bg_phi", "imm_dofs",
                 "imm_psi", "jxw", "points", "imm_cell_dofs", "m_local")
_ELASTICITY_KEYS = ("rhs_f1", "rhs_f2", "free", "bg_dofs", "bg_phi",
                    "imm_dofs", "imm_psi", "jxw", "imm_cell_dofs", "m_local")


def _starts(arrays, key):
    v = arrays.get(key)
    return None if v is None else [np.array(x) for x in v]


def _family_state(arrays: dict, device, dtype):
    """The nitsche or elasticity problem's state (``arrays["problem"]``)."""
    nitsche = arrays["problem"] == "nitsche"
    keys = _NITSCHE_KEYS if nitsche else _ELASTICITY_KEYS
    missing = [k for k in keys if k not in arrays]
    if missing:
        raise KeyError(f"state_from_jax: missing arrays {missing}")

    def ten(key, dt=dtype):
        return torch.as_tensor(np.array(arrays[key]), dtype=dt,
                               device=device)

    dofs = np.asarray(arrays["imm_cell_dofs"])
    m = int(dofs.max()) + 1
    M = CellMatrix(dofs, dofs, np.asarray(arrays["m_local"]), (m, m),
                   device=device, dtype=dtype)
    if nitsche:
        rhs_f = ten("rhs_f")
        return NitscheState(
            rhs_f=rhs_f, rhs_g=ten("rhs_g"),
            coupling=Coupling(arrays["bg_dofs"], arrays["bg_phi"],
                              arrays["imm_dofs"], arrays["imm_psi"],
                              arrays["jxw"], (m, rhs_f.shape[0]),
                              device=device, dtype=dtype,
                              points=arrays["points"]),
            M=M, lanczos_starts=_starts(arrays, "lanczos_starts"))
    rhs_f1 = ten("rhs_f1")
    n_comp = len(np.asarray(arrays["rhs_f2"])) // m
    return ElasticityState(
        rhs_f1=rhs_f1, rhs_f2=ten("rhs_f2"), free=ten("free", torch.bool),
        coupling=Coupling(arrays["bg_dofs"], arrays["bg_phi"],
                          arrays["imm_dofs"], arrays["imm_psi"],
                          arrays["jxw"], (m, rhs_f1.shape[0] // n_comp),
                          device=device, dtype=dtype),
        M=M, lanczos_starts=_starts(arrays, "lanczos_starts"),
        lanczos_starts_a22=_starts(arrays, "lanczos_starts_a22"))


def state_from_jax(arrays: dict, device, dtype):
    """Load a reference problem's setup arrays (NumPy) for a port problem's
    ``load_state``.

    With ``rhs_u`` among the arrays this is the Stokes problem's state
    (:class:`StokesState`, for
    :meth:`..models.stokes.StokesProblem.load_state`): ``rhs_u`` and
    ``rhs_g`` (component-major), ``bc_values``, ``free``, the scalar
    coupling table, the immersed mass (per-cell ``m_local`` on
    ``imm_cell_dofs``), the pressure mass (``mp_local``, shared by the cells
    of ``p_cell_dofs``) and optionally the Lanczos start vectors of the
    velocity hierarchy (``lanczos_starts``, fine level first, each of
    ``spacedim·n_level`` entries).

    With ``rhs_f1`` among the arrays this is the elliptic interface
    problem's state (:class:`EllipticState`, for
    :meth:`..models.elliptic_interface.EllipticInterfaceProblem.load_state`):
    ``rhs_f1``, ``rhs_f2``, ``bc_values``, ``free``, the coupling table, the
    local matrices of A1 (``a1_local``, shared by the cells of
    ``a1_cell_dofs``), A2 and M (``a2_local``, ``m_local``, per cell of
    ``imm_cell_dofs``), and optionally the Lanczos start vectors of the A11
    hierarchy (``lanczos_starts``, fine level first) and of A22's
    (``lanczos_starts_a22``: its GMG levels, or the one vector of the
    off-lattice Chebyshev).

    With ``problem`` set to ``"nitsche"`` this is the nitsche problem's
    state (:class:`NitscheState`, for
    :meth:`..models.nitsche_bcs.NitscheProblem.load_state`): ``rhs_f``,
    ``rhs_g``, the coupling table with its quadrature ``points``, the
    multiplier mass (``m_local`` per cell of ``imm_cell_dofs``) and
    optionally the Lanczos start vectors of the bulk hierarchy
    (``lanczos_starts``).  With ``problem`` set to ``"elasticity"`` it is the
    elasticity interface problem's (:class:`ElasticityState`, for
    :meth:`..models.elasticity.ElasticityInterfaceProblem.load_state`):
    ``rhs_f1``, ``rhs_f2`` (component-major), ``free``, the scalar coupling
    table, the scalar immersed mass and optionally the Lanczos start vectors
    of the A11 and A22 hierarchies (``lanczos_starts``,
    ``lanczos_starts_a22``, each of ``dim·n_level`` entries).

    Otherwise it is the immersed_laplace problem's (:class:`CarriedState`,
    for :meth:`..models.immersed_laplace.ImmersedLaplaceProblem.load_state`).

    ``arrays`` holds ``rhs_f``, ``rhs_g``, ``bc_values``, ``free``, the
    coupling table ``bg_dofs``, ``bg_phi``, ``imm_dofs``, ``imm_psi``,
    ``jxw``, the immersed mass diagonal ``m_diag`` and optionally
    ``lanczos_starts``, a list of per-level Lanczos start vectors (fine level
    first; the augmented operator's GMG and ``K⁻¹``'s have the same levels
    and the reference draws the same vector for both).  Each vector keeps
    its own dtype: the reference draws them in the Lanczos precision, float64
    for a float64 hierarchy and float32 for a bfloat16 one
    (``gmg.py:376-393``), and the port's Lanczos in that precision then
    starts from the same values.  With
    ``imm_cell_dofs``, ``m_local`` and ``a_local`` (per-cell local matrices)
    the whole immersed mass and stiffness matrices are carried, as the
    rational mode needs them."""
    if "problem" in arrays:
        return _family_state(arrays, device, dtype)
    if "rhs_u" in arrays:
        return _stokes_state(arrays, device, dtype)
    if "rhs_f1" in arrays:
        return _elliptic_state(arrays, device, dtype)
    missing = [k for k in _KEYS if k not in arrays]
    if missing:
        raise KeyError(f"state_from_jax: missing arrays {missing}")

    def ten(key, dt=dtype):
        return torch.as_tensor(np.array(arrays[key]), dtype=dt,
                               device=device)

    rhs_f, rhs_g = ten("rhs_f"), ten("rhs_g")
    coupling = Coupling(arrays["bg_dofs"], arrays["bg_phi"],
                        arrays["imm_dofs"], arrays["imm_psi"], arrays["jxw"],
                        (rhs_g.shape[0], rhs_f.shape[0]), device=device,
                        dtype=dtype)
    starts = arrays.get("lanczos_starts")
    mass, stiffness = DiagonalMatrix(ten("m_diag")), None
    if "m_local" in arrays:
        dofs, n = arrays["imm_cell_dofs"], rhs_g.shape[0]

        def cell_matrix(key):
            return CellMatrix(dofs, dofs, np.asarray(arrays[key]), (n, n),
                              device=device, dtype=dtype)

        mass, stiffness = cell_matrix("m_local"), cell_matrix("a_local")
    return CarriedState(
        rhs_f=rhs_f, rhs_g=rhs_g, bc_values=ten("bc_values"),
        free=ten("free", torch.bool), coupling=coupling,
        mass=mass, stiffness=stiffness,
        lanczos_starts=None if starts is None
        else [np.array(v) for v in starts])
