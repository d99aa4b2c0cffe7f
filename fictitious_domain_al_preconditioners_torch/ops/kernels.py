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
  planes) in four modes, ``op``, ``smooth``, ``pre`` and ``post``, in
  float32 and in bfloat16 storage (float32 arithmetic, one rounding a
  store; the bf16 V-cycle's levels, a form the reference does not have).
- **K6** :func:`laplace_stencil_2d` replaces ``_conv9_pallas``
  (``pallas_kernels.py:31``) with the edge corrections of
  ``SeparableStencil2D``: the unconstrained Q1 stiffness apply, in float32
  and in float64 (one body, templated on the element type).

K2 is CUDA C++ for ``sm_90a``: the sweep kernel in ``csrc/fdal_sweep.cuh``,
instantiated for ``smooth`` and the no-patch ``op`` (and its C entry points)
in ``csrc/fdal_kernels.cu``, for ``pre`` in ``csrc/fdal_pre.cu`` and for
``post`` in ``csrc/fdal_post.cu``, and in bf16 storage for every mode in
``csrc/fdal_sweep_bf16.cu``.  The single-application kernels share the
register window of ``csrc/fdal_window.cuh``: K1 (both forms) in
``csrc/fdal_masked.cu``, K2's ``op`` with the patch in
``csrc/fdal_augmented.cu`` and K6 in ``csrc/fdal_stencil.cu``.  All sit behind
a plain C interface; :func:`build` compiles the sources with ``nvcc`` (one
process each, run together) into one library under ``build/torch_kernels/``
at first use, called through ctypes.  Nothing is built or imported from CUDA
when this module is imported.

Dispatch rule of every wrapper: a CPU tensor goes to the plain PyTorch
version; a CUDA tensor launches the kernel (float32, or bfloat16 for K1
and K2, or float64 for K6; contiguous) or raises.  Each launch adds one to
:data:`LAUNCHES` (K1 and K6 per dtype form, K2 per mode, per form: with
or without patch planes, and per dtype).  Inside
:func:`recording_launches` (a CUDA graph's capture, which runs nothing) a
launch is recorded instead, with its call record (:func:`call_record`);
the graph's owner adds the record to :data:`LAUNCHES` and
:data:`GRAPH_CALLS` at each replay.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

__all__ = ["LAUNCHES", "GRAPH_CALLS", "reset_launch_counts",
           "recording_launches", "call_record", "build", "source_tag",
           "stencil_factors_2d",
           "masked_laplace_2d", "masked_laplace_2d_plain",
           "laplace_stencil_2d", "laplace_stencil_2d_plain",
           "AugmentedStencil2D", "fused_augmented_2d",
           "fused_augmented_2d_plain", "fused_augmented_resources",
           "masked_laplace_resources", "masked_laplace_tile", "K1_CHUNKS",
           "laplace_stencil_resources", "laplace_stencil_tile",
           "augmented_op_resources", "augmented_op_tile",
           "WINDOW_KEEP", "WINDOW_WARPS", "PATCH_CHUNK", "window_plan",
           "launch_key", "MODES", "SWEEP_TILE", "sweep_output_tile"]

MODES = ("op", "smooth", "pre", "post")
_MODE_ID = {m: i for i, m in enumerate(MODES)}
_MAX_DEGREE = 6  # csrc/fdal_sweep.cuh MAX_DEG
#: the extended tile of K2's sweep kernel, rows x columns
#: (csrc/fdal_sweep.cuh EY, EX): ``smooth``, ``pre``, ``post`` in both forms
#: and ``op`` without patch; ``op`` with the patch is cut by
#: :func:`window_plan` (csrc/fdal_augmented.cu)
SWEEP_TILE = (32, 96)


def sweep_output_tile(mode: str, degree: int = 4) -> tuple[int, int]:
    """The points of the sweep kernel's extended tile that a block writes in
    ``mode``: the tile less a halo of one point per operator application
    (``op``: the form without patch; the patched ``op`` is not this kernel,
    see :func:`augmented_op_tile`)."""
    halo = 1 if mode == "op" else degree - (mode == "smooth")
    return SWEEP_TILE[0] - 2 * halo, SWEEP_TILE[1] - 2 * halo


#: the register window of K1, the patched K2 ``op`` and K6
#: (csrc/fdal_window.cuh KEEP, WARPS): a warp writes 30 of the 32 columns it
#: loads, a block is 4 warps side by side
WINDOW_KEEP = 30
WINDOW_WARPS = 4
_MIDDLE_POINTS = 1 << 17  # csrc/fdal_window.cuh MIDDLE_POINTS
_LARGE_POINTS = 1 << 22   # csrc/fdal_window.cuh LARGE_POINTS
#: most rows of a chunk of the patched ``op``'s warps that meet the box
#: (csrc/fdal_augmented.cu PATCH_CHUNK)
PATCH_CHUNK = 4


def window_plan(ny: int, nx: int, itemsize: int = 4) -> dict:
    """How the window kernels cut an (ny, nx) lattice of ``itemsize``-byte
    values, mirrored from ``size_plan`` of csrc/fdal_window.cuh (no library
    is built): ``chunk_rows`` a lane loads ahead, ``run_rows`` of its run (a
    block writes ``run_rows`` rows) and the ``tile_columns`` a block
    writes."""
    points = ny * nx
    if points < _MIDDLE_POINTS:
        chunk = run = 1
    elif points < _LARGE_POINTS:
        chunk = run = 4
    else:
        chunk, run = 8, 32 // itemsize
    return dict(chunk_rows=chunk, run_rows=run,
                tile_columns=WINDOW_KEEP * WINDOW_WARPS)


def launch_key(mode: str, patch: bool = True, bf16: bool = False) -> str:
    """The :data:`LAUNCHES` key of K2 in ``mode``, with or without patch,
    in float32 or in bf16 storage."""
    return (f"fused_augmented_2d:{mode}" + ("" if patch else ":no_patch")
            + (":bf16" if bf16 else ""))


#: kernel launches made by the wrappers, keyed by kernel (K1 and K6 by dtype
#: form, K2 by mode, form and dtype)
LAUNCHES = {"masked_laplace_2d": 0, "masked_laplace_2d:bf16": 0,
            "laplace_stencil_2d": 0, "laplace_stencil_2d:f64": 0,
            **{launch_key(m, p, h): 0 for h in (False, True)
               for p in (True, False) for m in MODES}}


#: kernel-entry calls that ran inside CUDA graph replays, keyed by their
#: :func:`call_record`: a replay passes no wrapper, so these calls are
#: counted here, from the record of the graph's capture, and by no profiler
#: range of a wrapper call
GRAPH_CALLS = collections.Counter()

# the list recording the launches of a capture, None outside one
_recording = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    GRAPH_CALLS.clear()


def call_record(kernel: str, t: torch.Tensor, **extra) -> tuple:
    """The record of one kernel-entry call: its entry, the lattice's shape,
    the dtype, and for K2 ``mode``, ``box`` and ``degree``, as sorted
    ``(name, value)`` pairs (``dict(record)`` reads it)."""
    fields = dict(kernel=kernel, shape=tuple(t.shape),
                  dtype=str(t.dtype).replace("torch.", ""), cuda=True,
                  **extra)
    return tuple(sorted(fields.items()))


def _launched(key: str, record):
    """Count one launch under ``key`` in :data:`LAUNCHES`, or, inside
    :func:`recording_launches`, record it with ``record()``."""
    if _recording is None:
        LAUNCHES[key] += 1
    else:
        _recording.append((key, record()))


@contextlib.contextmanager
def recording_launches():
    """Record the wrappers' launches made inside, without counting them:
    yields the list of their ``(LAUNCHES key, call record)``, for a CUDA
    graph's capture, whose launches run only when it is replayed."""
    global _recording
    outer, _recording = _recording, []
    try:
        yield _recording
    finally:
        _recording = outer


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG_DIR, "csrc", f)
                for f in ("fdal_kernels.cu", "fdal_pre.cu", "fdal_post.cu",
                          "fdal_stencil.cu", "fdal_masked.cu",
                          "fdal_augmented.cu", "fdal_sweep_bf16.cu"))
HEADERS = tuple(os.path.join(_PKG_DIR, "csrc", f)
                for f in ("fdal_sweep.cuh", "fdal_window.cuh"))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_tag() -> str:
    """Hash of every source and header that :func:`build` compiles."""
    digest = hashlib.sha1()
    for src in SOURCES + HEADERS:
        with open(src, "rb") as fh:
            digest.update(fh.read())
    return digest.hexdigest()[:12]


def build() -> str:
    """Compile the CUDA sources for sm_90a, one ``nvcc`` process each, all
    started together, and link them into one shared library under
    ``build/torch_kernels/`` (named by the sources' hash, so an edited source
    rebuilds); return its path."""
    tag = source_tag()
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
    lib.fdal_masked_laplace_resources.argtypes = [ci, ci, vp]
    lib.fdal_masked_laplace_resources.restype = ci
    lib.fdal_masked_laplace_plan.argtypes = [ci, ci, ci, vp]
    lib.fdal_masked_laplace_plan.restype = ci
    lib.fdal_laplace_stencil_2d.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.fdal_laplace_stencil_2d.restype = ci
    lib.fdal_laplace_stencil_2d_f64.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.fdal_laplace_stencil_2d_f64.restype = ci
    lib.fdal_laplace_stencil_resources.argtypes = [ci, vp]
    lib.fdal_laplace_stencil_resources.restype = ci
    lib.fdal_laplace_stencil_f64_resources.argtypes = [ci, vp]
    lib.fdal_laplace_stencil_f64_resources.restype = ci
    lib.fdal_laplace_stencil_plan.argtypes = [ci, ci, vp]
    lib.fdal_laplace_stencil_plan.restype = ci
    lib.fdal_augmented_op_2d.argtypes = [vp, vp, vp, ci, ci, vp, ci, ci, ci,
                                         ci, vp]
    lib.fdal_augmented_op_2d.restype = ci
    lib.fdal_augmented_op_resources.argtypes = [ci, vp]
    lib.fdal_augmented_op_resources.restype = ci
    lib.fdal_augmented_op_plan.argtypes = [ci, ci, vp]
    lib.fdal_augmented_op_plan.restype = ci
    lib.fdal_fused_augmented_2d.argtypes = [ci, ci, vp, vp, vp, vp, vp, ci,
                                            ci, vp, ci, ci, ci, ci, vp, vp]
    lib.fdal_fused_augmented_2d.restype = ci
    lib.fdal_fused_augmented_resources.argtypes = [ci, ci, ci, vp]
    lib.fdal_fused_augmented_resources.restype = ci
    lib.fdal_fused_augmented_2d_bf16.argtypes = \
        lib.fdal_fused_augmented_2d.argtypes
    lib.fdal_fused_augmented_2d_bf16.restype = ci
    lib.fdal_fused_augmented_bf16_resources.argtypes = [ci, ci, vp]
    lib.fdal_fused_augmented_bf16_resources.restype = ci
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
    _launched(key, lambda: call_record("masked_laplace_2d", u))
    return out


#: the chunks (rows a thread loads ahead and unrolls) K1, the patched K2
#: ``op`` and K6 are instantiated for; a launch picks one from the lattice's
#: size (csrc/fdal_window.cuh)
K1_CHUNKS = (1, 4, 8)
_WINDOW_RESOURCES = ("registers", "local_bytes", "static_smem_bytes",
                     "blocks_per_sm", "threads", "tile_columns")


def _window_resources(what: str, query, *args) -> dict:
    """The resources one instantiation of a window kernel reports through
    its C query ``query(*args, res)`` (builds the library)."""
    res = np.zeros(6, dtype=np.int32)
    _check_rc(query(*args, res.ctypes.data), what)
    return dict(zip(_WINDOW_RESOURCES, (int(v) for v in res)))


def masked_laplace_resources(bf16: bool = False, chunk: int = 8) -> dict:
    """What one instantiation of K1 takes of the card (builds the library):
    registers a thread, local (spilled) bytes a thread, static shared bytes
    a block, resident blocks an SM, threads a block and the columns a block
    writes.  ``chunk`` is one of :data:`K1_CHUNKS`."""
    return _window_resources(
        f"masked_laplace_resources({bf16}, {chunk})",
        _library().fdal_masked_laplace_resources, int(bf16), int(chunk))


def masked_laplace_tile(ny: int, nx: int, bf16: bool = False) -> dict:
    """How K1 cuts an (ny, nx) lattice (builds the library): ``chunk_rows``
    and ``run_rows`` of the launch's plan (a block writes ``run_rows`` rows)
    and the ``tile_columns`` a block writes."""
    plan = np.zeros(2, dtype=np.int32)
    _check_rc(_library().fdal_masked_laplace_plan(
        int(bf16), int(ny), int(nx), plan.ctypes.data), "masked_laplace_tile")
    return dict(chunk_rows=int(plan[0]), run_rows=int(plan[1]),
                tile_columns=masked_laplace_resources(
                    bf16, int(plan[0]))["tile_columns"])


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


def laplace_stencil_resources(chunk: int = 8, f64: bool = False) -> dict:
    """What K6's instantiation of ``chunk`` (one of :data:`K1_CHUNKS`) takes
    of the card (builds the library), in float32 or (``f64``) float64; the
    keys of :func:`masked_laplace_resources`."""
    lib = _library()
    return _window_resources(
        f"laplace_stencil_resources({chunk}, {f64})",
        lib.fdal_laplace_stencil_f64_resources if f64
        else lib.fdal_laplace_stencil_resources, int(chunk))


def laplace_stencil_tile(ny: int, nx: int) -> dict:
    """How K6 cuts an (ny, nx) lattice, asked of the library (builds it):
    the keys of :func:`window_plan`, which mirrors it.  Both dtype forms
    take this plan."""
    plan = np.zeros(2, dtype=np.int32)
    _check_rc(_library().fdal_laplace_stencil_plan(
        int(ny), int(nx), plan.ctypes.data), "laplace_stencil_tile")
    return dict(chunk_rows=int(plan[0]), run_rows=int(plan[1]),
                tile_columns=laplace_stencil_resources(
                    int(plan[0]))["tile_columns"])


def laplace_stencil_2d(u: torch.Tensor, h) -> torch.Tensor:
    """K6: unconstrained Q1 stiffness apply ``(K0⊗M1 + M0⊗K1) u`` on an
    (ny, nx) lattice tensor; ``h`` is the cell size per lattice axis.  On
    CUDA a float32 tensor runs the float32 kernel and a float64 tensor the
    float64 one; any other dtype raises."""
    if u.device.type == "cpu":
        return laplace_stencil_2d_plain(u, h)
    _check_cuda("laplace_stencil_2d", u,
                dtypes=(torch.float32, torch.float64))
    if u.dim() != 2:
        raise ValueError("laplace_stencil_2d: expected an (ny, nx) tensor")
    f64 = u.dtype == torch.float64
    ny, nx = u.shape
    out = torch.empty_like(u)
    fac = np.array([v for f in _edge_factors_2d(h) for v in f],
                   dtype=np.float64 if f64 else np.float32)
    lib = _library()
    fn = (lib.fdal_laplace_stencil_2d_f64 if f64
          else lib.fdal_laplace_stencil_2d)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), out.data_ptr(), ny, nx, fac.ctypes.data, stream)
    key = "laplace_stencil_2d:f64" if f64 else "laplace_stencil_2d"
    _check_rc(rc, key)
    _launched(key, lambda: call_record("laplace_stencil_2d", u))
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

    def row_block(self, a: int, b: int) -> "AugmentedStencil2D":
        """This operator on the block of lattice rows ``[a, b)`` (all
        columns), as a kernel sees it: the block's first and last rows take
        the mask of boundary rows, and the patch box is clipped to the
        block's interior rows ``[a+1, b-1)`` and shifted into block
        coordinates (no patch when nothing of it is left).  Clipping changes
        nothing but those two rows: a boundary row's output is its input and
        its input enters no other row, whatever the patch weighs it with.
        The rows of the block that lie ``k`` rows or more from a block edge
        that is not a lattice edge hold the lattice operator's values after
        ``k - 1`` applications (``parallel.mesh.HALO``)."""
        ny, nx = self.shape
        if not 0 <= a < b <= ny:
            raise ValueError(f"row block [{a}, {b}) outside {ny} rows")
        shape = (b - a, nx)
        if self.patched:
            r0, c0, pr, pc = self.box
            lo, hi = max(r0, a + 1), min(r0 + pr, b - 1)
            if lo < hi:
                return AugmentedStencil2D(
                    self.h, shape, self.planes[:, lo - r0:hi - r0],
                    (lo - a, c0, hi - lo, pc))
        return AugmentedStencil2D(self.h, shape, device=self.device,
                                  dtype=self.dtype)

    @functools.cached_property
    def float32(self) -> "AugmentedStencil2D":
        """This operator with its planes widened to float32 (exact), the
        plain form's of a bfloat16 stencil; itself when float32."""
        if self.dtype == torch.float32:
            return self
        if not self.patched:
            return AugmentedStencil2D(self.h, self.shape, device=self.device,
                                      dtype=torch.float32)
        return AugmentedStencil2D(self.h, self.shape, self.planes.float(),
                                  self.box)

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
    (the unfused composition the reference runs off the TPU).  A bfloat16
    ``b`` (and ``x0``) is widened to float32 with the stencil's planes
    (:attr:`AugmentedStencil2D.float32`), and each output rounded to
    bfloat16 once: the bf16-storage kernel's semantics, as K1's bf16 form
    (:func:`masked_laplace_2d_plain`)."""
    from ..precond.chebyshev import chebyshev

    if b.dtype == torch.bfloat16:
        out = fused_augmented_2d_plain(
            mode, st.float32, b.float(), None if x0 is None else x0.float(),
            lam_max=lam_max, degree=degree, eig_ratio=eig_ratio)
        if mode == "pre":
            return out[0].to(b.dtype), out[1].to(b.dtype)
        return out.to(b.dtype)
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
    set the Chebyshev sweep (unused in ``op``).  On CUDA ``b``'s dtype picks
    the kernel: float32, or bfloat16 storage (``csrc/fdal_sweep_bf16.cu``;
    ``x0`` and the planes in the same dtype, float32 arithmetic, each output
    rounded once), counted under ``launch_key(mode, patched, bf16=True)``."""
    if mode not in _MODE_ID:
        raise ValueError(f"unknown mode {mode!r}")
    if (mode == "post") != (x0 is not None):
        raise ValueError("x0 is given in post mode and only there")
    if b.device.type == "cpu":
        return fused_augmented_2d_plain(mode, st, b, x0, lam_max=lam_max,
                                        degree=degree, eig_ratio=eig_ratio)
    ny, nx = st.shape
    _check_cuda("fused_augmented_2d: b", b, (ny, nx),
                (torch.float32, torch.bfloat16))
    bf16 = b.dtype == torch.bfloat16
    if st.patched:
        _check_cuda("fused_augmented_2d: planes", st.planes, dtypes=(b.dtype,))
    if st.device != b.device:
        raise ValueError("fused_augmented_2d: stencil on another device")
    if x0 is not None:
        _check_cuda("fused_augmented_2d: x0", x0, (ny, nx), (b.dtype,))
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
        if bf16:
            rc = lib.fdal_fused_augmented_2d_bf16(
                _MODE_ID[mode], int(degree), b.data_ptr(),
                None if x0 is None else x0.data_ptr(),
                st.planes.data_ptr() if st.patched else None,
                out.data_ptr(), None if rout is None else rout.data_ptr(),
                ny, nx, fac.ctypes.data, r0, c0, pr, pc, coef.ctypes.data,
                stream)
        elif mode == "op" and st.patched:
            # one application with the patch: the window kernel
            rc = lib.fdal_augmented_op_2d(
                b.data_ptr(), st.planes.data_ptr(), out.data_ptr(), ny, nx,
                fac.ctypes.data, r0, c0, pr, pc, stream)
        else:
            rc = lib.fdal_fused_augmented_2d(
                _MODE_ID[mode], int(degree), b.data_ptr(),
                None if x0 is None else x0.data_ptr(),
                st.planes.data_ptr() if st.patched else None,
                out.data_ptr(), None if rout is None else rout.data_ptr(),
                ny, nx, fac.ctypes.data, r0, c0, pr, pc, coef.ctypes.data,
                stream)
    _check_rc(rc, f"fused_augmented_2d({mode})")
    _launched(launch_key(mode, st.patched, bf16), lambda: call_record(
        "fused_augmented_2d", b, mode=mode, box=tuple(st.box),
        degree=int(degree)))
    return (out, rout) if mode == "pre" else out


def augmented_op_resources(chunk: int = 8) -> dict:
    """What the patched ``op``'s instantiation of ``chunk`` (one of
    :data:`K1_CHUNKS`) takes of the card (builds the library); the keys of
    :func:`masked_laplace_resources`."""
    return _window_resources(f"augmented_op_resources({chunk})",
                             _library().fdal_augmented_op_resources,
                             int(chunk))


def augmented_op_tile(ny: int, nx: int) -> dict:
    """How the patched ``op`` cuts an (ny, nx) lattice, asked of the library
    (builds it): the keys of :func:`window_plan`, which mirrors it, and
    ``patch_chunk_rows``, the chunk of the warps that meet the box
    (``min(chunk_rows, PATCH_CHUNK)``)."""
    plan = np.zeros(3, dtype=np.int32)
    _check_rc(_library().fdal_augmented_op_plan(
        int(ny), int(nx), plan.ctypes.data), "augmented_op_tile")
    return dict(chunk_rows=int(plan[0]), run_rows=int(plan[1]),
                tile_columns=augmented_op_resources(
                    int(plan[0]))["tile_columns"],
                patch_chunk_rows=int(plan[2]))


def fused_augmented_resources(mode: str, degree: int = 4,
                              patch: bool = True, chunk: int = 8,
                              bf16: bool = False) -> dict:
    """What one K2 instantiation takes of the card (builds the library):
    registers a thread, static and dynamic shared bytes a block, local
    (spilled) bytes a thread, resident blocks an SM and threads a block.
    ``op`` with the patch is the window kernel of csrc/fdal_augmented.cu in
    its instantiation of ``chunk`` (no dynamic shared memory).  ``bf16``:
    the bf16-storage sweep of csrc/fdal_sweep_bf16.cu, whose every mode
    and form runs the patched instantiation (``patch`` and ``chunk``
    unused)."""
    keys = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
            "local_bytes", "blocks_per_sm", "threads")
    if bf16:
        res = np.zeros(6, dtype=np.int32)
        _check_rc(_library().fdal_fused_augmented_bf16_resources(
            _MODE_ID[mode], int(degree), res.ctypes.data),
            f"fused_augmented_resources({mode}, {degree}, bf16)")
        return dict(zip(keys, (int(v) for v in res)))
    if mode == "op" and patch:
        res = augmented_op_resources(chunk)
        return dict(registers=res["registers"],
                    static_smem_bytes=res["static_smem_bytes"],
                    dynamic_smem_bytes=0, local_bytes=res["local_bytes"],
                    blocks_per_sm=res["blocks_per_sm"],
                    threads=res["threads"])
    res = np.zeros(6, dtype=np.int32)
    _check_rc(_library().fdal_fused_augmented_resources(
        _MODE_ID[mode], int(degree), int(patch), res.ctypes.data),
        f"fused_augmented_resources({mode}, {degree}, {patch})")
    return dict(zip(keys, (int(v) for v in res)))
