"""ctypes bindings of the host C++ setup routines.

Counterpart of ``fictitious_domain_al_preconditioners_tpu/native.py``, with
its four entries and ``available()``, the same argument and return types:
point location on a uniform grid, tensor Lagrange tabulation at reference
points, COO deduplication and the dense compact-AL accumulation (the role
deal.II's C++ plays in the reference's setup).  The solve runs on the card;
these change setup time only, and every entry has a NumPy form that gives
the same tables.

The source is the port's own copy, ``csrc/fdal_setup.cpp``.  It is built at
first use with ``g++ -O3 -march=native -fPIC -shared -std=c++17`` (the
library is built on the machine that runs it) into
``build/torch_native/libfdal_setup_<source hash>.so``, through a per-process
temporary file and ``os.replace``, so that processes building at once do not
collide.  ``available()`` is False only when no C++ compiler is found; then
the NumPy forms run.  A compiler that is found but fails raises with its
stderr.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

__all__ = ["available", "locate_points", "tabulate", "coo_dedup",
           "accumulate_al", "build"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fdal_setup.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_native")
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def _compiler():
    return shutil.which("g++") or shutil.which("c++")


def source_tag() -> str:
    """Hash of the source and the flags :func:`build` compiles it with."""
    digest = hashlib.sha1(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return digest.hexdigest()[:12]


def build():
    """Compile ``csrc/fdal_setup.cpp`` into ``build/torch_native/`` (named by
    :func:`source_tag`, so an edited source rebuilds) and return the
    library's path; None when no C++ compiler is found."""
    cxx = _compiler()
    if cxx is None:
        return None
    lib = os.path.join(BUILD_DIR, f"libfdal_setup_{source_tag()}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{cxx} failed on {SOURCE} ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.fdal_locate_points.argtypes = [f64p, ctypes.c_int64, ctypes.c_int,
                                       f64p, f64p, i64p, i64p, f64p]
    lib.fdal_locate_points.restype = None
    lib.fdal_tabulate.argtypes = [f64p, ctypes.c_int64, ctypes.c_int, f64p,
                                  ctypes.c_int, f64p]
    lib.fdal_tabulate.restype = None
    lib.fdal_coo_dedup.argtypes = [i64p, i64p, f64p, ctypes.c_int64,
                                   ctypes.c_int64]
    lib.fdal_coo_dedup.restype = ctypes.c_int64
    lib.fdal_accumulate_al.argtypes = [i64p, f64p, f64p, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_int64, f64p]
    lib.fdal_accumulate_al.restype = None
    return lib


def available() -> bool:
    """Whether the library is in use (False only without a C++ compiler)."""
    return _library() is not None


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def locate_points(points, origin, h, ncells):
    """Uniform-grid point location: ``(cells (n,) int64, ref (n, dim))``,
    the cell index lexicographic with the first coordinate fastest (as
    ``UniformGrid.locate``)."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    n, dim = points.shape
    if not available():
        rel = (points - np.asarray(origin)) / np.asarray(h)
        mi = np.clip(np.floor(rel).astype(np.int64), 0,
                     np.asarray(ncells) - 1)
        strides = np.cumprod([1] + list(ncells[:-1]))
        return (mi @ strides).astype(np.int64), rel - mi
    origin = np.ascontiguousarray(origin, dtype=np.float64)
    h = np.ascontiguousarray(h, dtype=np.float64)
    nc = np.ascontiguousarray(ncells, dtype=np.int64)
    cells = np.empty(n, dtype=np.int64)
    ref = np.empty((n, dim), dtype=np.float64)
    _library().fdal_locate_points(
        _ptr(points, ctypes.c_double), n, dim, _ptr(origin, ctypes.c_double),
        _ptr(h, ctypes.c_double), _ptr(nc, ctypes.c_int64),
        _ptr(cells, ctypes.c_int64), _ptr(ref, ctypes.c_double))
    return cells, ref


def tabulate(points, nodes_1d, dim):
    """Values (n, len(nodes_1d)**dim) of the tensor Lagrange basis on
    ``nodes_1d`` at reference points, first coordinate fastest (as
    ``FE.tabulate``)."""
    points = np.ascontiguousarray(np.atleast_2d(points), dtype=np.float64)
    n = points.shape[0]
    n_nodes = len(nodes_1d)
    if not available():
        from .core.fe import FE

        return FE(dim, n_nodes - 1).tabulate(points)
    nodes = np.ascontiguousarray(nodes_1d, dtype=np.float64)
    out = np.empty((n, n_nodes ** dim), dtype=np.float64)
    _library().fdal_tabulate(_ptr(points, ctypes.c_double), n, dim,
                             _ptr(nodes, ctypes.c_double), n_nodes,
                             _ptr(out, ctypes.c_double))
    return out


def coo_dedup(rows, cols, vals, ncols):
    """Sort COO triplets by (row, col) and sum duplicates: ``(rows, cols,
    vals)`` (as ``ops.sparse.coo_dedup``)."""
    if not available():
        from .ops.sparse import coo_dedup as numpy_dedup

        return numpy_dedup(rows, cols, vals, ncols)
    rows = np.array(rows, dtype=np.int64)
    cols = np.array(cols, dtype=np.int64)
    vals = np.array(vals, dtype=np.float64)
    n = _library().fdal_coo_dedup(_ptr(rows, ctypes.c_int64),
                                  _ptr(cols, ctypes.c_int64),
                                  _ptr(vals, ctypes.c_double), len(vals),
                                  np.int64(ncols))
    return rows[:n], cols[:n], vals[:n]


def accumulate_al(idx, phi, w, m):
    """Dense compact-AL accumulation ``A[idx_a, idx_b] += phi_a phi_b w``
    over the rows of ``idx``/``phi`` (nq, nloc): the (m, m) float64 block
    (as ``ops.coupling.accumulate_al``)."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    phi = np.ascontiguousarray(phi, dtype=np.float64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    if not available():
        from .ops.coupling import accumulate_al as numpy_accumulate

        return numpy_accumulate(idx, phi, w, m)
    nq, nloc = idx.shape
    A = np.zeros((m, m), dtype=np.float64)
    _library().fdal_accumulate_al(_ptr(idx, ctypes.c_int64),
                                  _ptr(phi, ctypes.c_double),
                                  _ptr(w, ctypes.c_double), nq, nloc, m,
                                  _ptr(A, ctypes.c_double))
    return A
