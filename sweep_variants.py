#!/usr/bin/env python3
"""Build variants of K2's sweep kernel, or of the window kernels (K1, the
patched K2 ``op``, K6), and time them in turns on one card.

    python3 sweep_variants.py tiles    # tile shapes against the committed one
    python3 sweep_variants.py split    # memory-only and compute-only probes
    python3 sweep_variants.py k1       # K1: layouts, run lengths and probes
    python3 sweep_variants.py k1 --parent DIR   # ... and an earlier tree's K1
    python3 sweep_variants.py op [--parent DIR]  # K2 op with the patch
    python3 sweep_variants.py k6 [--parent DIR]  # K6

Each variant is ``csrc/fdal_sweep.cuh`` with text substitutions, built with
its three instantiating sources into a library of its own under
``build/sweep_variants/`` (every nvcc process started together).  For each
variant the script prints the ptxas spills and, for ``pre`` and ``post`` at
degree 4 with and without patch, the registers a thread, shared bytes and
resident blocks an SM; it holds every variant that keeps the arithmetic
against the plain version at ``chip_smoke.py``'s tolerances on small edge
shapes; then it times ``pre`` and ``post`` at 4097² (the flagship's planes
at refinement 12, or none) for all variants in turns, forward then
backward, and prints the mean of each variant's two medians.

The ``split`` probes break the results on purpose: ``no_compute`` drops
the operator applications (loads, the Chebyshev updates and stores stay),
``no_memory`` replaces the lattice loads by values made in registers and
keeps the stores behind a test that never holds.

``k1`` builds ``csrc/fdal_masked.cu`` once per entry of ``K1_VARIANTS``, each
with its own ``-D`` flags (the probes the source names), into libraries
under ``build/sweep_variants/``; with ``--parent DIR`` (the root of another
checkout of this repository) it also builds that tree's K1, which has the
same C interface: its ``csrc/fdal_masked.cu`` or, in a tree of before K1 had
its own file, its ``csrc/fdal_stencil.cu``.  It
prints every variant's registers, spills and resident blocks an SM, holds
the variants that keep the arithmetic against the plain version in both
forms at small edge shapes, and then times both forms of every variant, and
a device copy of the same lattice, at every level shape of the flagship
hierarchy (4097² down to 5²), all variants in turns forward then backward
(so ``parent, as_is, ..., as_is, parent``), each as device ms a launch inside
a CUDA graph of 20 launches.  The table also goes to the file named by
``--out`` (``build/sweep_variants/k1_variants.json`` if not given).

``op`` and ``k6`` do the same for ``csrc/fdal_augmented.cu`` (``OP_VARIANTS``)
and ``csrc/fdal_stencil.cu`` (``K6_VARIANTS``): plans, and the probes without
arithmetic, without the plane loads and with the box test (``op``) or the
interior test (``k6``) off.  With ``--parent DIR`` the other checkout's kernel
of the same function is built and timed first and last: its
``fdal_stencil.cu`` for ``k6``; for ``op`` its K2 sources, whose sweep
template served ``op`` with the patch through ``fdal_fused_augmented_2d``.
The variants that keep the arithmetic are held against the plain version at
``chip_smoke.py``'s edge shapes.  ``k6`` is timed beside a device copy and
K1 at every level shape 4097² ... 5²; ``op`` likewise at 4097² with the
flagship's planes and box and, from 2049² down to 9², with a box of the same
share of the lattice (about 0.4 of each side) and random planes.  The table
goes to ``--out`` (``build/sweep_variants/<preset>_variants.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

PKG = "fictitious_domain_al_preconditioners_torch"
CSRC = os.path.join(PKG, "csrc")
OUT = os.path.join("build", "sweep_variants")
SOURCES = ("fdal_kernels.cu", "fdal_pre.cu", "fdal_post.cu")


def _sub(a, b):
    return [(f"constexpr int {a};", f"constexpr int {b};")]


PRESETS = {
    "tiles": {
        "as_is": [],
        "128x32": _sub("EX = 96", "EX = 128"),
        "128x64_1block": (_sub("EX = 96", "EX = 128") + _sub("RUN = 8", "RUN = 16")
                          + _sub("MIN_BLOCKS = 2", "MIN_BLOCKS = 1")),
        "64x48": _sub("EX = 96", "EX = 64") + _sub("TROWS = 4", "TROWS = 6"),
    },
    "split": {
        "as_is": [],
        "no_compute": [
            ("      apply_plain(zcol, s.w, dint, inm, v, emit);",
             "      for (int k = 0; k < RUN; ++k) emit(k, v[k], dint);"),
            ("    __syncthreads();  // the previous application's readers are "
             "done\n#pragma unroll\n    for (int k = 0; k < RUN; ++k) "
             "zcol[k * ZW] = ((inm >> k) & 1u) ? v[k] : 0.f;\n"
             "    __syncthreads();", "")],
        "no_memory": [
            ("rhs[k] = ((inl >> k) & 1u) ? widen(b[k * nx]) : 0.f;",
             "rhs[k] = ((inl >> k) & 1u) ? (float)(k + gc) : 0.f;"),
            ("x[k] = ((inl >> k) & 1u) ? widen(x0[k * nx]) : 0.f;",
             "x[k] = ((inl >> k) & 1u) ? (float)(k * gc) : 0.f;"),
            ("if ((inl >> k) & 1u) x[k] += widen(x0[k * nx]);",
             "if ((inl >> k) & 1u) x[k] += 1.f;"),
            ("((inl >> k) & 1u)) {\n        put(dst + k * nx, v[k]);",
             "v[k] == 12345.f) {\n        put(dst + k * nx, v[k]);")],
    },
}
# variants whose arithmetic is the kernel's (held against the plain version)
EXACT = {"as_is", "128x32", "128x64_1block", "64x48"}

# K1: the -D flags of each variant of csrc/fdal_masked.cu (the source's
# header comment says what each probe does)
K1_VARIANTS = {
    "as_is": [],
    "separable": ["-DFDAL_K1_SEPARABLE"],
    "smem_neighbours": ["-DFDAL_K1_SMEM"],
    # one chunk and run length for every lattice: u<chunk>r<run>
    **{f"u{u}r{r}": [f"-DFDAL_K1_UNROLL={u}", f"-DFDAL_K1_RUN={r}"]
       for u, r in ((1, 1), (2, 2), (4, 4), (4, 8), (8, 8), (8, 16), (8, 32),
                    (16, 16))},
    # registers capped for 12 and 16 blocks an SM
    "u8r8_b12": ["-DFDAL_K1_UNROLL=8", "-DFDAL_K1_MIN_BLOCKS=12"],
    "u4r4_b16": ["-DFDAL_K1_UNROLL=4", "-DFDAL_K1_MIN_BLOCKS=16"],
    "no_compute": ["-DFDAL_K1_NO_COMPUTE"],
    "no_loads": ["-DFDAL_K1_NO_LOADS"],
    "no_stores": ["-DFDAL_K1_NO_STORES"],
    "no_memory": ["-DFDAL_K1_NO_LOADS", "-DFDAL_K1_NO_STORES"],
}
K1_PROBES = {"no_compute", "no_loads", "no_stores", "no_memory"}


def _plans(prefix, plans):
    """The -D flags that fix chunk and run length: {u<chunk>r<run>: flags}."""
    return {f"u{u}r{r}": [f"-DFDAL_{prefix}_UNROLL={u}",
                          f"-DFDAL_{prefix}_RUN={r}"] for u, r in plans}


# the patched K2 op: -D flags of each variant of csrc/fdal_augmented.cu
OP_VARIANTS = {
    "as_is": [],
    **_plans("OP", ((1, 1), (4, 4), (4, 8), (4, 16), (8, 8), (8, 16))),
    "no_compute": ["-DFDAL_OP_NO_COMPUTE"],
    "no_planes": ["-DFDAL_OP_NO_PLANES"],
    "all_patched": ["-DFDAL_OP_ALL_PATCHED"],
}
OP_PROBES = {"no_compute", "no_planes"}
# K6: -D flags of each variant of csrc/fdal_stencil.cu
K6_VARIANTS = {
    "as_is": [],
    **_plans("K6", ((1, 1), (4, 4), (4, 8), (8, 8), (8, 16))),
    "no_compute": ["-DFDAL_K6_NO_COMPUTE"],
    "all_edge": ["-DFDAL_K6_ALL_EDGE"],
}
K6_PROBES = {"no_compute"}
K1_LEVELS = [2 ** k + 1 for k in range(12, 1, -1)]       # 4097 ... 5
K1_EDGE_SHAPES = [(5, 5), (9, 9), (17, 17), (3, 50), (5, 200), (65, 65),
                  (97, 161), (63, 239), (65, 242), (511, 599), (530, 777),
                  (1025, 1025), (2241, 2161)]


def build_single(prefix, todo):
    """Compile {name: (source, flags)}, each source into a library of its
    own under ``build/sweep_variants/<prefix>_<name>/``, all nvcc processes
    started together; return {name: (ctypes lib, ptxas lines)}."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-shared"]
    jobs = {}
    for name, (src, defs) in todo.items():
        d = os.path.join(OUT, f"{prefix}_{name}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        lib = os.path.join(d, "lib.so")
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, *defs, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err[-3000:]}")
        ptxas = [line.split("ptxas info    : ")[-1] for line in
                 err.splitlines() if "registers" in line or "spill" in line]
        libs[name] = (ctypes.CDLL(os.path.abspath(lib)), ptxas)
    return libs


def build_k1(parent):
    """Compile every K1 variant (and the parent's K1, if given)."""
    todo = {name: (os.path.join(CSRC, "fdal_masked.cu"), defs)
            for name, defs in K1_VARIANTS.items()}
    if parent:
        # K1's own file, or the file it shared with K6 before it had one
        src = os.path.join(parent, CSRC, "fdal_masked.cu")
        if not os.path.exists(src):
            src = os.path.join(parent, CSRC, "fdal_stencil.cu")
        todo = {"parent": (src, []), **todo}
    return build_single("k1", todo)


def main_window(args, kind) -> int:
    """The presets ``op`` and ``k6``: build, report, check, time."""
    import torch

    import chip_smoke as S
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    source, variants, probes = {
        "op": ("fdal_augmented.cu", OP_VARIANTS, OP_PROBES),
        "k6": ("fdal_stencil.cu", K6_VARIANTS, K6_PROBES)}[kind]
    t0 = time.perf_counter()
    libs = build_single(kind, {name: (os.path.join(CSRC, source), defs)
                               for name, defs in variants.items()})
    parent = None
    if args.parent and kind == "k6":
        parent = build_single(kind, {"parent": (os.path.join(
            args.parent, CSRC, "fdal_stencil.cu"), [])})["parent"][0]
    elif args.parent:
        parent = build({"op_parent": []},
                       csrc=os.path.join(args.parent, CSRC))["op_parent"][0]
    print(f"built {len(libs) + bool(parent)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    prefix = "fdal_augmented_op" if kind == "op" else "fdal_laplace_stencil"
    for name, (lib, ptxas) in libs.items():
        fn = getattr(lib, prefix + "_2d")
        fn.argtypes = ([vp, vp, vp, ci, ci, vp, ci, ci, ci, ci, vp]
                       if kind == "op" else [vp, vp, ci, ci, vp, vp])
        getattr(lib, prefix + "_resources").argtypes = [ci, vp]
        getattr(lib, prefix + "_plan").argtypes = [ci, ci, vp]
        plans, chunks = {}, {}
        for n in (65, 1025, 4097):
            plan = np.zeros(3, np.int32)
            getattr(lib, prefix + "_plan")(n, n, plan.ctypes.data)
            plans[str(n)] = [int(v) for v in plan[:2]]
            r = np.zeros(6, np.int32)
            if getattr(lib, prefix + "_resources")(int(plan[0]),
                                                   r.ctypes.data):
                raise SystemExit(f"{name}: resources failed")
            chunks[str(plan[0])] = dict(
                registers=int(r[0]), local_bytes=int(r[1]),
                static_smem_bytes=int(r[2]), blocks_per_sm=int(r[3]))
        print(json.dumps(dict(variant=name, plans=plans, chunks=chunks,
                              ptxas=ptxas)), flush=True)
    if parent is not None and kind == "op":
        parent.fdal_fused_augmented_2d.argtypes = [
            ci, ci, vp, vp, vp, vp, vp, ci, ci, vp, ci, ci, ci, ci, vp, vp]
    elif parent is not None:
        parent.fdal_laplace_stencil_2d.argtypes = [vp, vp, ci, ci, vp, vp]
    coef = np.ones(8, np.float32)    # op reads no Chebyshev coefficient

    def call(name, u, out, st):
        """Variant ``name`` (or the parent) on the lattice ``u``; ``st`` is
        the stencil (``op``) or the cell sizes (``k6``)."""
        ny, nx = u.shape
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "k6":
            lib = parent if name == "parent" else libs[name][0]
            fac = np.array([v for f in K._edge_factors_2d(st) for v in f],
                           dtype=np.float32)
            rc = lib.fdal_laplace_stencil_2d(u.data_ptr(), out.data_ptr(), ny,
                                             nx, fac.ctypes.data, stream)
        elif name == "parent":
            fac = K._stencil_args(st.h)
            rc = parent.fdal_fused_augmented_2d(
                0, 4, u.data_ptr(), None, st.planes.data_ptr(),
                out.data_ptr(), None, ny, nx, fac.ctypes.data, *st.box,
                coef.ctypes.data, stream)
        else:
            fac = K._stencil_args(st.h)
            rc = libs[name][0].fdal_augmented_op_2d(
                u.data_ptr(), st.planes.data_ptr(), out.data_ptr(), ny, nx,
                fac.ctypes.data, *st.box, stream)
        if rc:
            raise RuntimeError(f"{name}: launch failed ({rc})")
        return out

    def field(shape, seed):
        return torch.as_tensor(
            np.random.default_rng(seed).standard_normal(shape),
            dtype=torch.float32, device=dev)

    names = (["parent"] if parent is not None else []) + list(libs)
    failed = False
    if kind == "k6":
        cases = [(shape, tuple(1.0 / max(n - 1, 1) for n in shape))
                 for shape in S.window_edge_shapes()]
    else:
        cases = [(shape, S.random_patch_stencil(shape, box, dev, seed=i))
                 for i, (shape, box) in enumerate(S.op_edge_cases())]
    tol = S.TOL["op" if kind == "op" else "laplace_stencil_2d"]
    for name in names:
        if name in probes:
            continue
        worst = 0.0
        for shape, st in cases:
            u = field(shape, seed=sum(shape))
            got = call(name, u, torch.empty_like(u), st)
            torch.cuda.synchronize()
            ref = (K.fused_augmented_2d_plain("op", st, u) if kind == "op"
                   else K.laplace_stencil_2d_plain(u, st))
            rel = float((got.double() - ref.double()).abs().max()
                        / ref.double().abs().max()) / tol
            worst = max(worst, rel)
            if not rel <= 1:
                failed = True
                print(f"FAIL {name} {shape} "
                      f"{st.box if kind == 'op' else ''}: {rel:.3e} of the "
                      "tolerance", flush=True)
        print(f"{name}: worst error / tolerance {worst:.3f} over "
              f"{len(cases)} cases", flush=True)
    del cases

    table = []
    for n in K1_LEVELS:
        h = (1.0 / (n - 1),) * 2
        if kind == "k6":
            st = h
        elif n == 4097:
            planes, box = S.flagship_planes(12, dev)
            st = K.AugmentedStencil2D(h, (n, n), planes, box)
        elif n >= 9:
            lo, side = max((n - 1) // 5 - 1, 1), 2 * (n - 1) // 5 + 3
            st = S.random_patch_stencil((n, n), (lo, lo, side, side), dev,
                                        seed=n)
        else:
            continue
        u = field((n, n), seed=8)
        out = torch.empty_like(u)
        others = {"copy": lambda: out.copy_(u),
                  "k1": lambda: K.masked_laplace_2d(u, h)}
        ms = {name: [] for name in names + list(others)}
        for name in names + list(others) + names[::-1]:
            fn = others.get(name) or (lambda: call(name, u, out, st))
            ms[name].append(S.graph_time_ms(fn))
        row = {"kernel": kind, "shape": [n, n],
               "ms": {k: [round(x, 6) for x in v] for k, v in ms.items()}}
        if kind == "op":
            row["box"] = list(st.box)
            row["bound_ms"] = S.fused_bound("op", st, 0)[0]
        else:
            row["bound_ms"] = S.bound(8 * n * n, S.STENCIL_FLOPS * n * n)[0]
        table.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(table, fh, indent=1)
    return 1 if failed else 0


def main_k1(args) -> int:
    import torch

    import chip_smoke as S
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build_k1(args.parent)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (lib, ptxas) in libs.items():
        for fn in (lib.fdal_masked_laplace_2d,
                   lib.fdal_masked_laplace_2d_bf16):
            fn.argtypes = [vp, vp, ci, ci, vp, vp]
            fn.restype = ci
        res = {}
        if name != "parent":
            lib.fdal_masked_laplace_resources.argtypes = [ci, ci, vp]
            lib.fdal_masked_laplace_plan.argtypes = [ci, ci, ci, vp]
            for form in (0, 1):
                # the plan (chunk, run) at each size, and the resources of
                # each chunk's instantiation
                plans, chunks = {}, {}
                for n in (65, 1025, 4097):
                    plan = np.zeros(2, np.int32)
                    lib.fdal_masked_laplace_plan(form, n, n, plan.ctypes.data)
                    plans[str(n)] = [int(v) for v in plan]
                    r = np.zeros(6, np.int32)
                    if lib.fdal_masked_laplace_resources(form, int(plan[0]),
                                                         r.ctypes.data):
                        raise SystemExit(f"{name}: resources failed")
                    chunks[str(plan[0])] = dict(
                        registers=int(r[0]), local_bytes=int(r[1]),
                        static_smem_bytes=int(r[2]), blocks_per_sm=int(r[3]))
                res["bf16" if form else "float32"] = dict(plans=plans,
                                                          chunks=chunks)
        print(json.dumps(dict(variant=name, resources=res, ptxas=ptxas)),
              flush=True)

    def call(lib, u, out, fac):
        fn = (lib.fdal_masked_laplace_2d_bf16 if u.dtype == torch.bfloat16
              else lib.fdal_masked_laplace_2d)
        rc = fn(u.data_ptr(), out.data_ptr(), u.shape[0], u.shape[1],
                fac.ctypes.data, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc})")
        return out

    def field(shape, bf16, seed):
        u = torch.as_tensor(np.random.default_rng(seed).standard_normal(shape),
                            dtype=torch.float32, device=dev)
        return u.to(torch.bfloat16) if bf16 else u

    failed = False
    for name, (lib, _) in libs.items():
        if name in K1_PROBES:
            continue
        worst = {}
        for shape in K1_EDGE_SHAPES:
            h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
            fac = K._stencil_args(h)
            for bf16 in (False, True):
                u = field(shape, bf16, seed=sum(shape))
                got = call(lib, u, torch.empty_like(u), fac)
                torch.cuda.synchronize()
                ref = K.masked_laplace_2d_plain(u, h)
                key = "masked_laplace_2d" + (":bf16" if bf16 else "")
                rel = float((got.double() - ref.double()).abs().max()
                            / ref.double().abs().max()) / S.TOL[key]
                worst[key] = max(worst.get(key, 0.0), rel)
                if not rel <= 1:
                    failed = True
                    print(f"FAIL {name} {shape} {key}: {rel:.3e} of the "
                          "tolerance", flush=True)
        print(f"{name}: worst error / tolerance {json.dumps(worst)}",
              flush=True)

    names = list(libs)
    table = []
    for n in K1_LEVELS:
        h = (1.0 / (n - 1),) * 2
        fac = K._stencil_args(h)
        for bf16 in (False, True):
            u = field((n, n), bf16, seed=8)
            out = torch.empty_like(u)
            ms = {name: [] for name in names + ["copy"]}
            for name in names + ["copy"] + names[::-1]:
                fn = ((lambda: out.copy_(u)) if name == "copy" else
                      (lambda: call(libs[name][0], u, out, fac)))
                ms[name].append(S.graph_time_ms(fn))
            row = {"form": "bf16" if bf16 else "float32", "shape": [n, n],
                   "ms": {k: [round(x, 6) for x in v] for k, v in ms.items()}}
            table.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(table, fh, indent=1)
    return 1 if failed else 0


def build(variants, csrc=CSRC):
    """Write and compile every variant of the K2 sources under ``csrc``;
    return {name: (ctypes lib, spills)}."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    jobs = []
    for name, subs in variants.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f in ("fdal_sweep.cuh",) + SOURCES:
            text = open(os.path.join(csrc, f)).read()
            if f == "fdal_sweep.cuh":
                for a, b in subs:
                    if a not in text:
                        raise SystemExit(f"{name}: {a!r} not in the header")
                    text = text.replace(a, b)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        for f in SOURCES:
            cmd = [nvcc, *flags, "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c",
                   "-o", os.path.join(d, f + ".o"), os.path.join(d, f)]
            jobs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    spills = {name: [] for name in variants}
    for name, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err[-3000:]}")
        entry = None
        for line in err.splitlines():
            if "Compiling entry" in line:
                entry = re.sub(r"_ZN4fdal.*sweep_kernelI", "", line.split("'")[1])
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)):
                spills[name].append((entry, int(m.group(1))))
    libs = {}
    for name in variants:
        d = os.path.join(OUT, name)
        lib = os.path.join(d, "lib.so")
        subprocess.run([nvcc, *flags, "-shared", "-o", lib]
                       + [os.path.join(d, f + ".o") for f in SOURCES],
                       check=True, capture_output=True)
        libs[name] = (ctypes.CDLL(os.path.abspath(lib)), spills[name])
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", choices=sorted(PRESETS) + ["k1", "op", "k6"])
    ap.add_argument("--parent", default=None,
                    help="k1, op, k6: root of another checkout, whose kernel "
                         "of the same function is timed beside the variants "
                         "(k1: its csrc/fdal_masked.cu, or fdal_stencil.cu "
                         "in a tree where that holds K1)")
    ap.add_argument("--out", default=None,
                    help="k1, op, k6: file the table of times is written to "
                         f"({OUT}/<preset>_variants.json if not given)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(OUT, f"{args.preset}_variants.json")

    import torch

    if not torch.cuda.is_available():
        print("sweep_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card {smi}", flush=True)
    if args.preset == "k1":
        return main_k1(args)
    if args.preset in ("op", "k6"):
        return main_window(args, args.preset)
    import chip_smoke as S
    from fictitious_domain_al_preconditioners_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build(PRESETS[args.preset])
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (lib, spills) in libs.items():
        lib.fdal_fused_augmented_2d.argtypes = [ci, ci, vp, vp, vp, vp, vp,
                                                ci, ci, vp, ci, ci, ci, ci,
                                                vp, vp]
        lib.fdal_fused_augmented_resources.argtypes = [ci, ci, ci, vp]
        res = {}
        for patch in (True, False):
            for mode in ("pre", "post"):
                r = np.zeros(6, np.int32)
                rc = lib.fdal_fused_augmented_resources(
                    K._MODE_ID[mode], 4, int(patch), r.ctypes.data)
                if rc:
                    raise SystemExit(f"{name}: resources failed ({rc})")
                res[mode + ("" if patch else ":no_patch")] = dict(
                    registers=int(r[0]), dynamic_smem_bytes=int(r[2]),
                    local_bytes=int(r[3]), blocks_per_sm=int(r[4]),
                    threads=int(r[5]))
        print(json.dumps(dict(variant=name, spills=spills, resources=res)),
              flush=True)

    def call(lib, mode, st, b, x0, degree=4, lam=1.2):
        ny, nx = st.shape
        theta, coeffs = K._cheb_scalars(lam, degree, 30.0)
        coef = np.array([1.0 / theta] + [a for a, _ in coeffs]
                        + [c for _, c in coeffs], dtype=np.float32)
        fac = K._stencil_args(st.h)
        out = torch.empty_like(b)
        rout = torch.empty_like(b) if mode == "pre" else None
        r0, c0, pr, pc = st.box
        rc = lib.fdal_fused_augmented_2d(
            K._MODE_ID[mode], degree, b.data_ptr(),
            None if x0 is None else x0.data_ptr(),
            st.planes.data_ptr() if st.patched else None, out.data_ptr(),
            None if rout is None else rout.data_ptr(), ny, nx,
            fac.ctypes.data, r0, c0, pr, pc, coef.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc})")
        return (out, rout) if mode == "pre" else out

    def stencil(shape, box):
        h = (1.0 / (shape[0] - 1), 1.0 / (shape[1] - 1))
        if box is None:
            return K.AugmentedStencil2D(h, shape, device=dev,
                                        dtype=torch.float32)
        planes = np.random.default_rng(1).uniform(
            0.1, 1.0, (5,) + tuple(box[2:])).astype(np.float32)
        return K.AugmentedStencil2D(h, shape, torch.as_tensor(planes,
                                                              device=dev), box)

    cases = [((121, 239), (24, 120, 48, 119), 4), ((17, 17), (0, 0, 17, 17), 6),
             ((97, 161), (20, 30, 40, 50), 2), ((1025, 1025), None, 4),
             ((1025, 1025), (200, 300, 400, 500), 4), ((9, 9), None, 4)]
    failed = False
    for name, (lib, _) in libs.items():
        if name not in EXACT:
            continue
        worst = 0.0
        for shape, box, deg in cases:
            st = stencil(shape, box)
            rng = np.random.default_rng(0)
            b, x0 = (torch.as_tensor(rng.standard_normal(shape),
                                     dtype=torch.float32, device=dev)
                     for _ in range(2))
            for mode in ("pre", "post", "smooth"):
                xin = x0 if mode == "post" else None
                got = call(lib, mode, st, b, xin, deg, 1.5)
                ref = K.fused_augmented_2d_plain(mode, st, b, xin,
                                                 lam_max=1.5, degree=deg)
                for g, r in (zip(got, ref) if mode == "pre" else [(got, ref)]):
                    rel = float((g.double() - r.double()).abs().max()
                                / r.double().abs().max()) / S.TOL[mode]
                    worst = max(worst, rel)
                    if rel > 1 or not bool(torch.isfinite(g).all()):
                        failed = True
                        print(f"FAIL {name} {shape} {box} {deg} {mode}",
                              flush=True)
        print(f"{name}: worst error / tolerance {worst:.3f}", flush=True)

    planes, box = S.flagship_planes(12, dev)
    n = 4097
    h = (1.0 / (n - 1),) * 2
    forms = {"": K.AugmentedStencil2D(h, (n, n), planes, box),
             ":no_patch": K.AugmentedStencil2D(h, (n, n), device=dev,
                                               dtype=torch.float32)}
    rng = np.random.default_rng(7)
    b, x0 = (torch.as_tensor(rng.standard_normal((n, n)), dtype=torch.float32,
                             device=dev) for _ in range(2))
    names = list(libs)
    for form, st in forms.items():
        for mode in ("pre", "post"):
            xin = x0 if mode == "post" else None
            ms = {name: [] for name in names}
            for name in names + names[::-1]:
                ms[name].append(S.cuda_time_ms(
                    lambda: call(libs[name][0], mode, st, b, xin), 20))
            print(json.dumps({"mode": mode + form, "shape": [n, n], "ms": {
                name: sum(v) / len(v) for name, v in ms.items()}}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
