"""The PyTorch port imports without jax, and importing it builds nothing."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "fictitious_domain_al_preconditioners_torch"
MODULES = [
    PKG, f"{PKG}.core", f"{PKG}.ops", f"{PKG}.ops.kernels", f"{PKG}.precond",
    f"{PKG}.parallel", f"{PKG}.models", f"{PKG}.utils",
    f"{PKG}.models.immersed_laplace", f"{PKG}.utils.carry",
    f"{PKG}.ops.krylov", f"{PKG}.ops.operators", f"{PKG}.ops.assembly",
    f"{PKG}.parallel.lattice", f"{PKG}.precond.rational",
    f"{PKG}.precond.gmg", f"{PKG}.ops.host_ref", f"{PKG}.utils.refine",
]


def _run(code, env_extra=None):
    env = dict(os.environ, PYTHONPATH=ROOT, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=90)


def test_port_imports_with_jax_blocked():
    code = ("import sys\nsys.modules['jax'] = None\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "assert sys.modules['jax'] is None\n"
            "assert 'fictitious_domain_al_preconditioners_tpu' not in "
            "sys.modules\nprint('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_package_sources_import_no_jax():
    offenders = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, PKG)):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                for name in _imported_names(p):
                    top = name.split(".")[0]
                    if top in ("jax", "jaxlib",
                               "fictitious_domain_al_preconditioners_tpu"):
                        offenders.append((p, name))
    for name in _imported_names(os.path.join(ROOT, "chip_smoke.py")):
        if name.split(".")[0] in ("jax", "jaxlib",
                                  "fictitious_domain_al_preconditioners_tpu"):
            offenders.append(("chip_smoke.py", name))
    assert not offenders, offenders


@pytest.mark.parametrize("path_env", ["", "/nonexistent"])
def test_kernels_import_and_cpu_use_need_no_nvcc(path_env):
    """Importing ops.kernels and running its wrappers (K1 in float64 and
    bf16, K6, K2 with and without patch) on CPU tensors neither builds nor
    loads the CUDA library (no nvcc on PATH)."""
    code = f"""
import os, numpy as np, torch
from {PKG}.ops import kernels as K
u = torch.as_tensor(np.random.default_rng(0).standard_normal((9, 11)))
K.masked_laplace_2d(u, (0.125, 0.1))
assert K.masked_laplace_2d(u.to(torch.bfloat16), (0.125, 0.1)).dtype \
    == torch.bfloat16
planes = torch.zeros((5, 3, 4), dtype=u.dtype); planes[0] = 1.0
st = K.AugmentedStencil2D((0.125, 0.1), (9, 11), planes, (3, 3, 3, 4))
K.laplace_stencil_2d(u, (0.125, 0.1))
bare = K.AugmentedStencil2D((0.125, 0.1), (9, 11), device='cpu',
                            dtype=u.dtype)
for s in (st, bare):
    for mode in K.MODES:
        K.fused_augmented_2d(mode, s, u, u if mode == 'post' else None)
info = K._library.cache_info()
assert info.hits == 0 and info.misses == 0, info
assert sum(K.LAUNCHES.values()) == 0, K.LAUNCHES
print('ok')
"""
    res = _run(code, {"PATH": path_env} if path_env else None)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
