"""The lattice kernels: wrappers, plain PyTorch versions and the build of
their CUDA sources.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.ops.pallas_kernels``:

- **K1** :func:`masked_laplace_2d` replaces ``_masked_conv9_pallas``
  (``pallas_kernels.py:193``): the Dirichlet-masked Q1 stiffness apply
  ``m*K(m*u) + (1-m)*u`` on an (ny, nx) lattice, in float32 and in the
  reference's bfloat16-storage form (float32 arithmetic, one rounding).
- **K2** :func:`fused_augmented_2d` replaces ``fused_chebyshev_2d``
  (``pallas_kernels.py:394``): the masked augmented operator (stiffness plus
  the Γ-band AL patch, or the stiffness alone when the stencil has no patch
  planes) in four modes, ``op``, ``smooth``, ``pre`` and ``post``.
- **K6** :func:`laplace_stencil_2d` replaces ``_conv9_pallas``
  (``pallas_kernels.py:31``) with the edge corrections of
  ``SeparableStencil2D``: the unconstrained Q1 stiffness apply.

K2 is CUDA C++ for ``sm_90a`` in ``csrc/fdal_kernels.cu``, K1 and K6 in
``csrc/fdal_stencil.cu``, all behind a plain C interface; :func:`build`
compiles the sources with ``nvcc`` (one process each, run together) into one
library under ``build/torch_kernels/`` at first use, called through ctypes.
Nothing is built or imported from CUDA when this module is imported.

Dispatch rule of every wrapper: a CPU tensor goes to the plain PyTorch
version; a CUDA tensor launches the kernel (float32, or bfloat16 for K1;
contiguous) or raises.  Each launch adds one to :data:`LAUNCHES` (K1 per
dtype form, K2 per mode and per form: with or without patch planes).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "build", "stencil_factors_2d",
           "masked_laplace_2d", "masked_laplace_2d_plain",
           "laplace_stencil_2d", "laplace_stencil_2d_plain",
           "AugmentedStencil2D", "fused_augmented_2d",
           "fused_augmented_2d_plain", "launch_key", "MODES"]

MODES = ("op", "smooth", "pre", "post")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
_MAX_DEGREE = 6  # csrc/fdal_kernels.cu MAX_DEG


def launch_key(mode: str, patch: bool = True) -> str:
    """The :data:`LAUNCHES` key of K2 in ``mode``, with or without patch."""
    return f"fused_augmented_2d:{mode}" + ("" if patch else ":no_patch")


#: kernel launches made by the wrappers, keyed by kernel (K1 by dtype form,
#: K2 by mode and form)
LAUNCHES = {"masked_laplace_2d": 0, "masked_laplace_2d:bf16": 0,
            "laplace_stencil_2d": 0,
            **{launch_key(m, p): 0 for p in (True, False) for m in MODES}}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG_DIR, "csrc", f)
                for f in ("fdal_kernels.cu", "fdal_stencil.cu"))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile the CUDA sources for sm_90a, one ``nvcc`` process each, all
    started together, and link them into one shared library under
    ``build/torch_kernels/`` (named by the sources' hash, so an edited source
    rebuilds); return its path."""
    digest = hashlib.sha1()
    for src in SOURCES:
        with open(src, "rb") as fh:
            digest.update(fh.read())
    tag = digest.hexdigest()[:12]
    lib = os.path.join(BUILD_DIR, f"libfdal_kernels_{tag}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    jobs = []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}."
                                      f"{os.getpid()}.o")
        cmd = [nvcc, *flags, "-Xcompiler", "-fPIC", "-c", "-o", obj, src]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} ({proc.returncode}):\n{err}")
    tmp = f"{lib}.{os.getpid()}.tmp"
    if not errors:
        res = subprocess.run([nvcc, *flags, "-shared", "-o", tmp,
                              *(obj for _, obj, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            errors.append(f"nvcc link failed ({res.returncode}):\n"
                          f"{res.stderr}")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fdal_masked_laplace_2d.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.fdal_masked_laplace_2d.restype = ci
    lib.fdal_masked_laplace_2d_bf16.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.fdal_masked_laplace_2d_bf16.restype = ci
    lib.fdal_laplace_stencil_2d.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.fdal_laplace_stencil_2d.restype = ci
    lib.fdal_fused_augmented_2d.argtypes = [ci, ci, vp, vp, vp, vp, vp, ci,
                                            ci, vp, ci, ci, ci, ci, vp, vp]
    lib.fdal_fused_augmented_2d.restype = ci
    return lib


def stencil_factors_2d(h):
    """(K0, M0, K1, M1) 1D factors of the Q1 Laplace tensor-product stencil
    K0⊗M1 + M0⊗K1 for per-lattice-axis cell sizes ``h``."""
    h0, h1 = float(h[0]), float(h[1])
    K0 = np.array([-1.0 / h0, 2.0 / h0, -1.0 / h0])
    M0 = np.array([h0 / 6.0, 2.0 * h0 / 3.0, h0 / 6.0])
    K1 = np.array([-1.0 / h1, 2.0 / h1, -1.0 / h1])
    M1 = np.array([h1 / 6.0, 2.0 * h1 / 3.0, h1 / 6.0])
    return K0, M0, K1, M1


def _stencil_args(h) -> np.ndarray:
    """Host float32 array (k0o, k0c, m0o, m0c, k1o, k1c, m1o, m1c, Kc)."""
    K0, M0, K1, M1 = stencil_factors_2d(h)
    kc = K0[1] * M1[1] + M0[1] * K1[1]
    return np.array([K0[0], K0[1], M0[0], M0[1], K1[0], K1[1], M1[0], M1[1],
                     kc], dtype=np.float32)


def _cheb_scalars(lam_max: float, degree: int, eig_ratio: float,
                  lam_max_safety: float = 1.1):
    """Per-step Chebyshev coefficients (a_j, c_j) with p ← a_j p + c_j D⁻¹r,
    precomputed on the host from the Lanczos bound; mirrors
    :func:`..precond.chebyshev.chebyshev`."""
    lmax = float(lam_max) * lam_max_safety
    lmin = float(lam_max) / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    coeffs = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        coeffs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, coeffs


@functools.lru_cache(maxsize=32)
def _interior_mask(ny: int, nx: int, device: torch.device) -> torch.Tensor:
    rows = torch.arange(ny, device=device)
    cols = torch.arange(nx, device=device)
    return (((rows >= 1) & (rows <= ny - 2))[:, None]
            & ((cols >= 1) & (cols <= nx - 2))[None, :])


def _check_cuda(name, t, shape=None, dtypes=(torch.float32,)):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: the kernel takes {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _check_rc(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# --------------------------------------------------------------------- K1 --

def masked_laplace_2d_plain(u: torch.Tensor, h) -> torch.Tensor:
    """Plain PyTorch K1: the 9-point masked form of ``_masked_conv9_xla``,
    ``m*conv9(m*u) + (1-m)*u`` with ``m`` the interior mask.  A bfloat16
    input is widened to float32, and the result rounded to bfloat16 once:
    the TPU kernel's bf16 semantics (``pallas_kernels.py:219-259``), not
    the bf16 arithmetic of ``_masked_conv9_xla``."""
    if u.dtype == torch.bfloat16:
        return masked_laplace_2d_plain(u.float(), h).to(torch.bfloat16)
    ny, nx = u.shape
    K0, M0, K1, M1 = stencil_factors_2d(h)
    w = np.outer(K0, M1) + np.outer(M0, K1)
    m = _interior_mask(ny, nx, u.device)
    up = torch.nn.functional.pad(torch.where(m, u, 0.0), (1, 1, 1, 1))
    acc = None
    for di in range(3):
        for dj in range(3):
            t = float(w[di, dj]) * up[di:di + ny, dj:dj + nx]
            acc = t if acc is None else acc + t
    return torch.where(m, acc, u)


def masked_laplace_2d(u: torch.Tensor, h) -> torch.Tensor:
    """K1: constrained Q1 stiffness apply on an (ny, nx) lattice tensor;
    ``h`` is the cell size per lattice axis.  On CUDA a float32 tensor runs
    the float32 kernel and a bfloat16 tensor the bf16-storage kernel (float32
    arithmetic, one rounding); any other dtype raises."""
    if u.device.type == "cpu":
        return masked_laplace_2d_plain(u, h)
    _check_cuda("masked_laplace_2d", u,
                dtypes=(torch.float32, torch.bfloat16))
    if u.dim() != 2:
        raise ValueError("masked_laplace_2d: expected an (ny, nx) tensor")
    bf16 = u.dtype == torch.bfloat16
    ny, nx = u.shape
    out = torch.empty_like(u)
    fac = _stencil_args(h)
    lib = _library()
    fn = (lib.fdal_masked_laplace_2d_bf16 if bf16
          else lib.fdal_masked_laplace_2d)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), out.data_ptr(), ny, nx, fac.ctypes.data, stream)
    key = "masked_laplace_2d:bf16" if bf16 else "masked_laplace_2d"
    _check_rc(rc, key)
    LAUNCHES[key] += 1
    return out


# --------------------------------------------------------------------- K6 --

def _edge_factors_2d(h):
    """(off, centre, boundary centre) of the 1D factors K0, M0, K1, M1 of the
    unconstrained Q1 stiffness K0⊗M1 + M0⊗K1 (``laplace_stencil_2d`` of the
    reference, ``pallas_kernels.py:149-156``): a boundary node has half an
    interior node's support, so its centre is half the interior one."""
    return tuple((float(f[0]), float(f[1]), 0.5 * float(f[1]))
                 for f in stencil_factors_2d(h))


def _line_stencil(v, off, diag, axis):
    """3-point Toeplitz stencil with zero ends along ``axis`` of a 2D tensor."""
    v = torch.movedim(v, axis, 0)
    pad = torch.zeros_like(v[:1])
    out = diag * v + off * (torch.cat([pad, v[:-1]], 0)
                            + torch.cat([v[1:], pad], 0))
    return torch.movedim(out, 0, axis)


def laplace_stencil_2d_plain(u: torch.Tensor, h) -> torch.Tensor:
    """Plain PyTorch K6: ``SeparableStencil2D.__call__`` with ``_conv9_xla``
    (``pallas_kernels.py:81-146``), the constant 9-point stencil of the
    zero-padded input plus the rank-1 edge-row, edge-column and corner
    corrections of the boundary diagonals."""
    ny, nx = u.shape
    K0, M0, K1, M1 = _edge_factors_2d(h)
    pairs = ((K0, M1), (M0, K1))
    w = sum(np.outer([p0[0], p0[1], p0[0]], [p1[0], p1[1], p1[0]])
            for p0, p1 in pairs)
    up = torch.nn.functional.pad(u, (1, 1, 1, 1))
    out = None
    for di in range(3):
        for dj in range(3):
            t = float(w[di, dj]) * up[di:di + ny, dj:dj + nx]
            out = t if out is None else out + t
    rows = torch.stack([u[0], u[-1]])                # (2, nx)
    cols = torch.stack([u[:, 0], u[:, -1]], dim=1)   # (ny, 2)
    row_line = torch.zeros_like(rows)
    col_line = torch.zeros_like(cols)
    corner = 0.0
    for p0, p1 in pairs:
        c0, c1 = p0[2] - p0[1], p1[2] - p1[1]     # bdiag - diag
        row_line = row_line + c0 * _line_stencil(rows, p1[0], p1[1], 1)
        col_line = col_line + c1 * _line_stencil(cols, p0[0], p0[1], 0)
        corner += c0 * c1
    out[0] += row_line[0]
    out[-1] += row_line[1]
    out[:, 0] += col_line[:, 0]
    out[:, -1] += col_line[:, 1]
    for r, c in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        out[r, c] += corner * u[r, c]
    return out


def laplace_stencil_2d(u: torch.Tensor, h) -> torch.Tensor:
    """K6: unconstrained Q1 stiffness apply ``(K0⊗M1 + M0⊗K1) u`` on an
    (ny, nx) lattice tensor; ``h`` is the cell size per lattice axis."""
    if u.device.type == "cpu":
        return laplace_stencil_2d_plain(u, h)
    _check_cuda("laplace_stencil_2d", u)
    if u.dim() != 2:
        raise ValueError("laplace_stencil_2d: expected an (ny, nx) tensor")
    ny, nx = u.shape
    out = torch.empty_like(u)
    fac = np.array([v for f in _edge_factors_2d(h) for v in f],
                   dtype=np.float32)
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.fdal_laplace_stencil_2d(u.data_ptr(), out.data_ptr(), ny, nx,
                                         fac.ctypes.data, stream)
    _check_rc(rc, "laplace_stencil_2d")
    LAUNCHES["laplace_stencil_2d"] += 1
    return out


# --------------------------------------------------------------------- K2 --

class AugmentedStencil2D:
    """Data of the masked augmented lattice operator
    ``A x = m*(K + patch)(m*x) + (1-m)*x``.

    ``planes`` (5, pr, pc) holds the Γ-band patch on its box
    ``(r0, c0, pr, pc)`` in symmetric form: centre, (0,1), (1,0), (1,1),
    (1,-1), where plane ``e`` at point p weighs ``x[p+e]``; the mirrored
    offset ``-e`` weighs ``x[p-e]`` with ``plane_e[p-e]``.  ``h`` is the cell
    size per lattice axis and ``shape`` the lattice (ny, nx).

    Without planes (``planes=None``, box ``(0, 0, 0, 0)``) the operator is
    the constrained stiffness alone, the level operator of the reference's
    tight K inverse (``pallas_kernels.py:477, 580-583``); ``device`` and
    ``dtype`` then say where its tensors live (with planes they are the
    planes')."""

    OFFSETS = ((0, 1), (1, 0), (1, 1), (1, -1))

    def __init__(self, h, shape, planes: torch.Tensor | None = None,
                 box=(0, 0, 0, 0), *, device=None, dtype=None):
        self.h = (float(h[0]), float(h[1]))
        self.shape = (int(shape[0]), int(shape[1]))
        self.box = tuple(int(v) for v in box)
        r0, c0, pr, pc = self.box
        ny, nx = self.shape
        if planes is None:
            if self.box != (0, 0, 0, 0):
                raise ValueError(f"patch box {self.box} given without planes")
            if device is None or dtype is None:
                raise ValueError("a stencil without planes needs its device "
                                 "and dtype")
            self.planes = None
            self.device, self.dtype = torch.device(device), dtype
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        else:
            self.planes = planes.contiguous()
            self.device, self.dtype = self.planes.device, self.planes.dtype
            if not (0 <= r0 and r0 + pr <= ny and 0 <= c0 and c0 + pc <= nx
                    and pr > 0 and pc > 0):
                raise ValueError(f"patch box {self.box} outside lattice "
                                 f"{shape}")
            if tuple(self.planes.shape) != (5, pr, pc):
                raise ValueError(f"planes {tuple(self.planes.shape)} do not "
                                 f"match box {self.box}")
        K0, M0, K1, M1 = stencil_factors_2d(self.h)
        self.kc = float(K0[1] * M1[1] + M0[1] * K1[1])

    @property
    def patched(self) -> bool:
        return self.planes is not None

    @functools.cached_property
    def w9(self) -> torch.Tensor:
        """The 9 patch weight planes (3, 3, pr+2, pc+2) on the box grown by
        one point on each side, in the layout of ``Coupling.patch_w9``,
        rebuilt from the 5 symmetric planes: ``w_e = plane_e`` and
        ``w_{-e}[p] = plane_e[p-e]`` (planes are zero outside the box)."""
        P = torch.nn.functional.pad(self.planes, (1, 1, 1, 1))
        w9 = P.new_zeros((3, 3) + tuple(P.shape[1:]))
        w9[1, 1] = P[0]
        pr, pc = P.shape[1:]
        for k, (dr, dc) in enumerate(self.OFFSETS, start=1):
            w9[1 + dr, 1 + dc] = P[k]
            w9[1 - dr, 1 - dc][max(dr, 0):pr + min(dr, 0),
                               max(dc, 0):pc + min(dc, 0)] = \
                P[k][max(-dr, 0):pr - max(dr, 0), max(-dc, 0):pc - max(dc, 0)]
        return w9

    @functools.cached_property
    def dinv(self) -> torch.Tensor:
        """Chebyshev D⁻¹ = 1/(Kc + w_c) on interior points (w_c = 0 without
        patch), 1 elsewhere."""
        ny, nx = self.shape
        r0, c0, pr, pc = self.box
        wc = torch.zeros((ny, nx), dtype=self.dtype, device=self.device)
        if self.patched:
            wc[r0:r0 + pr, c0:c0 + pc] = self.planes[0]
        m = _interior_mask(ny, nx, self.device)
        return torch.where(m, 1.0 / (self.kc + wc), 1.0)

    def op_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Unfused augmented apply: K1-plain plus the masked 9-point patch
        (the composition of ``patch_al_lattice``), evaluated on the box grown
        by one point and clipped to the lattice."""
        out = masked_laplace_2d_plain(x, self.h)
        if not self.patched:
            return out
        ny, nx = self.shape
        r0, c0, pr, pc = self.box
        m = _interior_mask(ny, nx, x.device)
        zp = torch.nn.functional.pad(torch.where(m, x, 0.0), (2, 2, 2, 2))
        # grown box rows r0-1 .. r0+pr read z rows r0-2 .. r0+pr+1
        up = zp[r0:r0 + pr + 4, c0:c0 + pc + 4]
        w9 = self.w9
        acc = None
        for a in range(3):
            for b in range(3):
                term = w9[a, b] * up[a:a + pr + 2, b:b + pc + 2]
                acc = term if acc is None else acc + term
        ra, rb = max(r0 - 1, 0), min(r0 + pr + 1, ny)
        ca, cb = max(c0 - 1, 0), min(c0 + pc + 1, nx)
        acc = acc[ra - r0 + 1:rb - r0 + 1, ca - c0 + 1:cb - c0 + 1]
        out[ra:rb, ca:cb] += torch.where(m[ra:rb, ca:cb], acc, 0.0)
        return out


def fused_augmented_2d_plain(mode: str, st: AugmentedStencil2D, b, x0=None,
                             *, lam_max: float = 1.0, degree: int = 4,
                             eig_ratio: float = 30.0):
    """Plain PyTorch K2: ``chebyshev`` over :meth:`AugmentedStencil2D.op_plain`
    (the unfused composition the reference runs off the TPU)."""
    from ..precond.chebyshev import chebyshev

    if mode == "op":
        return st.op_plain(b)
    cheb = chebyshev(st.op_plain, st.dinv, lam_max, degree=degree,
                     eig_ratio=eig_ratio)
    if mode == "smooth":
        return cheb(b)
    if mode == "pre":
        x = cheb(b)
        return x, b - st.op_plain(x)
    if mode == "post":
        return x0 + cheb(b - st.op_plain(x0))
    raise ValueError(f"unknown mode {mode!r}")


def fused_augmented_2d(mode: str, st: AugmentedStencil2D, b, x0=None, *,
                       lam_max: float = 1.0, degree: int = 4,
                       eig_ratio: float = 30.0):
    """K2: the masked augmented operator ``A`` on an (ny, nx) lattice tensor.

    - ``op``:     ``b -> A b``
    - ``smooth``: ``b -> cheb_k(b)`` (degree-k Chebyshev sweep, x0 = 0)
    - ``pre``:    ``b -> (x, b - A x)`` with ``x = cheb_k(b)``
    - ``post``:   ``(b, x0) -> x0 + cheb_k(b - A x0)``

    ``lam_max`` is the Lanczos bound of D⁻¹A; ``degree`` and ``eig_ratio``
    set the Chebyshev sweep (unused in ``op``)."""
    if mode not in _MODE_ID:
        raise ValueError(f"unknown mode {mode!r}")
    if (mode == "post") != (x0 is not None):
        raise ValueError("x0 is given in post mode and only there")
    if b.device.type == "cpu":
        return fused_augmented_2d_plain(mode, st, b, x0, lam_max=lam_max,
                                        degree=degree, eig_ratio=eig_ratio)
    ny, nx = st.shape
    _check_cuda("fused_augmented_2d: b", b, (ny, nx))
    if st.patched:
        _check_cuda("fused_augmented_2d: planes", st.planes)
    if st.device != b.device:
        raise ValueError("fused_augmented_2d: stencil on another device")
    if x0 is not None:
        _check_cuda("fused_augmented_2d: x0", x0, (ny, nx))
    if mode != "op" and not 2 <= degree <= _MAX_DEGREE:
        raise ValueError(f"fused_augmented_2d: degree {degree} not in "
                         f"[2, {_MAX_DEGREE}]")
    theta, coeffs = (1.0, []) if mode == "op" else _cheb_scalars(
        lam_max, degree, eig_ratio)
    coef = np.array([1.0 / theta] + [a for a, _ in coeffs]
                    + [c for _, c in coeffs], dtype=np.float32)
    fac = _stencil_args(st.h)
    out = torch.empty_like(b)
    rout = torch.empty_like(b) if mode == "pre" else None
    r0, c0, pr, pc = st.box
    lib = _library()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = lib.fdal_fused_augmented_2d(
            _MODE_ID[mode], int(degree), b.data_ptr(),
            None if x0 is None else x0.data_ptr(),
            st.planes.data_ptr() if st.patched else None,
            out.data_ptr(), None if rout is None else rout.data_ptr(),
            ny, nx, fac.ctypes.data, r0, c0, pr, pc, coef.ctypes.data, stream)
    _check_rc(rc, f"fused_augmented_2d({mode})")
    LAUNCHES[launch_key(mode, st.patched)] += 1
    return (out, rout) if mode == "pre" else out
