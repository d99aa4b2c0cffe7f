"""The H100 results table's scripts (scripts/*_torch.py) on the CPU.

Every script runs in a subprocess that sets ``sys.modules['jax'] = None``
first; the rows' own subprocesses find stubs that refuse to import ``jax``
and the JAX package ahead of the repo on their path.  The counts that the
table must reproduce come from the JAX package's script run here, not from
numbers typed in."""

import importlib.util
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
TPU_PKG = "fictitious_domain_al_preconditioners_tpu"
# the smallest row of each family of the table, a small refined row (the
# table's smallest, refinement 9, takes over a minute on one core), the
# locally refined rows and the two studies at a small size
ROWS = ["laplace:7", "refined:6", "rational:5", "elliptic:0", "stokes:4:5",
        "stokes3d:3:0", "nitsche:0", "adaptive:flower_f1_g1:4:5",
        "gamma_study:3", "convergence_study:2"]
# measured at the same time by two measure_family_torch.py processes
FAMILY_ROWS = {"elasticity": "0", "adaptive_stokes": "3:4"}


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def blocked_env(tmp_path_factory):
    """An environment whose Python processes cannot import jax or the JAX
    package, one thread each."""
    stubs = tmp_path_factory.mktemp("stubs")
    for name in ("jax", TPU_PKG):
        (stubs / name).mkdir()
        (stubs / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    return dict(os.environ, PYTHONPATH=f"{stubs}{os.pathsep}{ROOT}",
                OMP_NUM_THREADS="1")


def _cmd(script, *args):
    code = ("import runpy, sys\nsys.modules['jax'] = None\n"
            f"sys.argv = {[script, *args]!r}\n"
            f"try:\n    runpy.run_path({os.path.join(SCRIPTS, script)!r}, "
            "run_name='__main__')\nfinally:\n"
            "    assert sys.modules['jax'] is None\n"
            f"    assert {TPU_PKG!r} not in sys.modules\n")
    return [sys.executable, "-c", code]


def _run(env, script, *args, cwd=ROOT, timeout=300):
    res = subprocess.run(_cmd(script, *args), env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return res.stdout


@pytest.fixture(scope="module")
def table(blocked_env, tmp_path_factory):
    """Two measure_family_torch.py processes and make_results_table_torch.py
    write one cache at the same time, while the JAX script computes its
    laplace 7 and nitsche 0 rows here; then the table is rendered.
    Returns ``(cache, table text, JAX rows)``."""
    tmp = tmp_path_factory.mktemp("table")
    cache, out = str(tmp / "rows.json"), str(tmp / "results.md")
    procs = [subprocess.Popen(
        cmd, env=blocked_env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for cmd in [
            _cmd("measure_family_torch.py", kind, arg, "--device", "cpu",
                 "--cache", cache) for kind, arg in FAMILY_ROWS.items()]
        + [_cmd("make_results_table_torch.py", "--device", "cpu", "--cache",
                cache, "--out", out, "--rows", ",".join(ROWS))]]
    try:
        jax_script = _module("make_results_table")
        jax_rows = {"laplace:7": jax_script.laplace_rows([7])[0],
                    "nitsche:0": jax_script.nitsche_rows([0])[0]}
        for proc in procs:
            text, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, text[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    _run(blocked_env, "make_results_table_torch.py", "--render", "--cache",
         cache, "--out", out)
    with open(cache) as fh, open(out) as fm:
        return json.load(fh), fm.read(), jax_rows


def test_every_family_renders_its_smallest_row(table):
    cache, text, _ = table
    mrt = _module("make_results_table_torch")
    keys = ROWS + [f"{k}:{a}" for k, a in FAMILY_ROWS.items()]
    for key in keys:
        ent = cache[key]
        assert ent["row"] is not None, (key, ent)
        assert ent["card"] == "cpu" and ent["device"] == "cpu"
        assert not mrt.row_is_stale(key.split(":", 1)[0], ent)
    for key in keys:
        kind = key.split(":", 1)[0]
        row = cache[key]["row"]
        if kind == "gamma_study":
            n, m, best, gammas, iters, _ = row
            assert len(gammas) == len(iters) == 3 and best in gammas
            assert f"best γ = {best:g}" in text
        elif kind == "convergence_study":
            rows, _ = row
            assert len(rows) == 2 and rows[1]["L2"] < rows[0]["L2"]
            assert f"| {rows[1]['dof_background']:,} |" in text
        else:
            assert f"| {row[0]:,} | {row[1]:,} | {row[2]} |" in text, key
            if len(row) >= 7:               # refined rows: to the tolerance
                assert row[6] and row[4] <= (1e-8 if "stokes" in kind
                                             else 1e-10), (key, row)
            else:
                assert math.isfinite(row[4]), (key, row)
    assert "Card (`nvidia-smi` name, power limit): cpu." in text
    assert "Every row is fresh" in text


def test_concurrent_writers_keep_every_row(table):
    cache, _, _ = table
    for kind, arg in FAMILY_ROWS.items():
        assert cache[f"{kind}:{arg}"]["row"] is not None
    assert all(cache[k]["row"] is not None for k in ROWS)


def test_laplace_7_equals_the_jax_script(table):
    cache, _, jax_rows = table
    jrow = jax_rows["laplace:7"]
    row = cache["laplace:7"]["row"]
    assert row[:3] == list(jrow[:3])


def test_nitsche_0_equals_the_jax_script(table):
    cache, _, jax_rows = table
    jrow = jax_rows["nitsche:0"]
    row = cache["nitsche:0"]["row"]
    assert row[:3] == list(jrow[:3]) and row[6] and jrow[6]


def test_cut_failed_and_marked_rows_render(blocked_env, tmp_path):
    cache, out = str(tmp_path / "rows.json"), str(tmp_path / "t.md")
    _run(blocked_env, "make_results_table_torch.py", "--device", "cpu",
         "--cache", cache, "--out", out, "--rows", "laplace:10",
         "--row-timeout", "4")
    with open(cache) as fh:
        ent = json.load(fh)["laplace:10"]
    assert ent["row"] is None and ent["cut"]["reason"] == "limit"
    assert ent["cut"]["limit"] == 4 and ent["cut"]["seconds"] >= 4
    long_err = "RuntimeError: " + " ".join(["CUDA out of memory"] * 20)
    mrt = _module("make_results_table_torch")
    stamp = dict(card="cpu", torch="x", cuda=None, device="cpu",
                 source=mrt.source_hash("elliptic"), measured="now")
    extra = {"elliptic:5": dict(stamp, row=None, err=long_err),
             "elliptic:6": dict(stamp, row=None, err="in progress"),
             "elliptic:3": dict(stamp, row=[66049, 4225, 19, 0, 1.6e-2,
                                            3.3, False]),
             "elliptic:4": dict(stamp, row=[263169, 16641, 17, 0,
                                            float("nan"), 6.7, False])}
    with open(tmp_path / "more.json", "w") as fh:
        json.dump(extra, fh)
    _run(blocked_env, "make_results_table_torch.py", "--render", "--cache",
         cache, "--out", out, "--merge", str(tmp_path / "more.json"))
    with open(out) as fh:
        text = fh.read()
    assert "`laplace:10`: **cut** at its 4 s limit" in text
    assert "`elliptic:6`: **cut**: its process ended during the row" in text
    line = next(x for x in text.splitlines() if "`elliptic:5`" in x)
    assert "failed: RuntimeError: CUDA out of memory" in line
    assert line.endswith("…") and len(line) < 200
    assert line[:-1].split()[-1] in long_err.split()
    assert "| 66,049 | 4,225 | 19 | 0 | 1.6e-02 **(unconverged)** |" in text
    assert "| 263,169 | 16,641 | 17 | 0 | **diverged** |" in text
    assert "`elliptic:0`: not run" in text


def test_error_text_is_cut_on_a_word_boundary():
    short = _module("make_results_table_torch").short
    assert short("a b c", 10) == "a b c"
    text = "UNAVAILABLE: worker process crashed or restarted, check it"
    cut = short(text, 30)
    assert cut == "UNAVAILABLE: worker process…"
    assert short("x" * 50, 10) == "x" * 9 + "…"


def test_a_killed_row_leaves_its_in_progress_entry(blocked_env, tmp_path):
    cache = str(tmp_path / "rows.json")
    proc = subprocess.Popen(
        _cmd("measure_family_torch.py", "laplace", "11", "--device", "cpu",
             "--cache", cache), env=blocked_env, cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if os.path.exists(cache):
                with open(cache) as fh:
                    ent = json.load(fh).get("laplace:11")
                if ent is not None:
                    break
            time.sleep(0.2)
        assert ent is not None and ent["err"] == "in progress"
        assert ent["pid"] == proc.pid
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    with open(cache) as fh:
        ent = json.load(fh)["laplace:11"]
    assert ent["row"] is None and ent["err"] == "in progress"


def test_run_experiments_on_a_shipped_prm(blocked_env, tmp_path):
    params = tmp_path / "params"
    params.mkdir()
    shutil.copy(os.path.join(ROOT, "parameters", "flower", "flower_f1_g1.prm"),
                params)
    log = _run(blocked_env, "run_experiments_torch.py", str(params),
               "--device", "cpu", cwd=str(tmp_path))
    assert "immersed_laplace" in log and "output_flower_f1_g1.log" in log
    with open(tmp_path / "output_flower_f1_g1.log") as fh:
        out = fh.read()
    assert "FAILED" not in out and out.strip()
    with open(tmp_path / "flower_f1_g1.csv") as fh:
        rows = fh.read().splitlines()
    assert rows[0].startswith("dofs_background") and len(rows) == 2
