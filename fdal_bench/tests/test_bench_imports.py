"""What a run may load: no JAX, no JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and a reference that
imports nothing of either package."""

import ast
import os
import subprocess
import sys
import textwrap

from fdal_bench import run, spec

REF_DIR = os.path.join(spec.PACKAGE_DIR, "reference")
PORT = "fictitious_domain_al_preconditioners_torch"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + ".models", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fictitious_domain_al_preconditioners_tpu.ops",
                        object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["fictitious_domain_al_preconditioners_tpu",
                                       "jaxlib"]


def test_reference_sources_import_neither_package():
    for name in os.listdir(REF_DIR):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF_DIR, name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "fdal_bench",
                                   PORT, "fictitious_domain_al_preconditioners_tpu"), \
                    f"{name} imports {m}"


def _python(code, tmp_path):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_program(tmp_path):
    last = _python("""
        import sys
        import fdal_bench.reference.laplace, fdal_bench.reference.stokes
        print(sorted({m.split('.')[0] for m in sys.modules}
                     & {'jax', 'jaxlib', 'flax',
                        'fictitious_domain_al_preconditioners_tpu',
                        'fictitious_domain_al_preconditioners_torch'}))
        """, tmp_path)
    assert last == "[]"


def test_a_run_loads_no_jax(tmp_path):
    last = _python(f"""
        import sys
        sys.path.insert(0, 'fdal_bench/tests')
        import torch
        from conftest import make_root
        from fdal_bench import run, spec
        root, pkg = make_root({str(tmp_path)!r})
        cell = spec.load_cell('laplace_circle.r12_f32', root=root,
                              package_dir=pkg)
        run.run_cell(cell, 7, 0.5, True, device='cpu')
        print(run.forbidden_modules())
        """, tmp_path)
    assert last == "[]"


def test_no_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "fdal_bench.run", "--workload",
         "laplace_circle.r12_f32", "--seed", "1", "--seconds", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the command fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.PACKAGE_DIR, tmp_path / "fdal_bench")
    out = subprocess.run(
        [sys.executable, "-m", "fdal_bench.run", "--workload",
         "laplace_circle.r12_f32", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "No module named 'fictitious_domain_al_preconditioners_torch'" \
        in out.stderr
