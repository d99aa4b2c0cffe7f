"""Tiny cells for the CPU tests: the benchmark's own files with each
configuration cut to a few thousand dofs, written into a temporary
checkout (``bench_root``), and the card fixture of the ``gpu`` tests."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from fdal_bench import spec

#: (background, immersed) refinements of each configuration in the tests
TINY = {"immersed_laplace": (5, 5), "stokes": (4, 5)}


def make_root(tmp, sample_horizon=2):
    """A checkout holding a copy of ``BENCHMARK.json`` and the benchmark's
    files, every configuration at :data:`TINY`'s size."""
    root = str(tmp)
    pkg = os.path.join(root, "fdal_bench")
    for sub in ("metrics", "traffic", "workloads", "configs"):
        shutil.copytree(os.path.join(spec.PACKAGE_DIR, sub),
                        os.path.join(pkg, sub))
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        ref, eref = TINY[cfg["family"]]
        cfg["problem"]["initial_refinement"] = ref
        cfg["problem"]["initial_embedded_refinement"] = eref
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    for w in bench["workloads"]:
        path = os.path.join(pkg, "workloads", f"{w['name']}.json")
        with open(path) as fh:
            wl = json.load(fh)
        wl["sample_horizon"] = sample_horizon
        wl["sample"] = min(wl["sample"], sample_horizon)
        wl["trace_solves"] = 0        # the profiler covers the whole window
        with open(path, "w") as fh:
            json.dump(wl, fh)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root, pkg


@pytest.fixture
def bench_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
