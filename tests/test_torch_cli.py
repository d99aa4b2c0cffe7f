"""The PyTorch port's command-line drivers
(``python -m fictitious_domain_al_preconditioners_torch.cli``), on the
CPU: every subcommand on a shipped parameter file (elasticity on the
inline copy of ``test_torch_elasticity.py``), refinements lowered by text
substitution, run in a temporary directory with ``--device cpu``.  The
immersed_laplace row of ``flower_f1_g1.csv`` equals the one the JAX
package's CLI, run in-process on the same file, writes in float64 on the
CPU, and the shipped circle and square files write the row of the port's
own solve;
``used_parameters.prm`` and the VTU files exist, with connectivity indices
below the point count; no ``jax`` module is loaded."""

import os
import re
import subprocess
import sys

import pytest
import torch

from fictitious_domain_al_preconditioners_torch import cli
from test_torch_elasticity import ELASTICITY_PRM

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(ROOT, "parameters")
# immersed_laplace files the port's CLI runs at their shipped sizes; the
# JAX package's CLI runs the first (its build takes 20-45 s)
STEMS = ("flower/flower_f1_g1", "circle/circle_f0_g1", "square/square_f1_g1")


@pytest.fixture(scope="module")
def jax_cli_row(tmp_path_factory):
    """``python -m fictitious_domain_al_preconditioners_tpu.cli
    immersed_laplace <file>`` on ``STEMS[0]``, run in-process in a
    temporary directory: the lines of its ``<stem>.csv``."""
    from fictitious_domain_al_preconditioners_tpu import cli as jcli

    out = tmp_path_factory.mktemp("jax_cli")
    cwd = os.getcwd()
    os.chdir(out)
    try:
        assert jcli.main(["immersed_laplace",
                          os.path.join(PARAMS, STEMS[0] + ".prm")]) == 0
    finally:
        os.chdir(cwd)
    return (out / f"{os.path.basename(STEMS[0])}.csv").read_text() \
        .splitlines()


def port_cli_rows(prm, tmp_path):
    """The port's CLI on ``prm`` in ``tmp_path`` (the working directory)
    with ``--device cpu``: the lines of its ``<stem>.csv``, after checking
    ``used_parameters.prm`` and the VTU files."""
    assert cli.main(["immersed_laplace", prm, "--device", "cpu"]) == 0
    name = os.path.splitext(os.path.basename(prm))[0]
    rows = (tmp_path / f"{name}.csv").read_text().splitlines()
    assert rows[0] == "dofs_background,dofs_immersed,outer_iterations"
    used = (tmp_path / "used_parameters.prm").read_text()
    assert "delta_refinement = 1" in used
    for vtu in ("solution_background.vtu", "multiplier.vtu"):
        check_vtu(tmp_path / vtu)
    return rows


def check_vtu(path):
    text = open(path).read()
    n = int(re.search(r'NumberOfPoints="(\d+)"', text).group(1))
    conn = re.search(r'Name="connectivity" format="ascii">\s*([\d\s]+)<',
                     text).group(1).split()
    assert n > 0 and conn and max(int(c) for c in conn) < n


def prm_copy(tmp_path, name, subs, text=None):
    if text is None:
        with open(os.path.join(PARAMS, name)) as fh:
            text = fh.read()
    for old, new in subs:
        assert old in text, old
        text = text.replace(old, new)
    out = tmp_path / os.path.basename(name)
    out.write_text(text)
    return str(out)


def test_immersed_laplace_row_matches_jax_cli(tmp_path, monkeypatch,
                                              jax_cli_row):
    monkeypatch.chdir(tmp_path)
    assert port_cli_rows(os.path.join(PARAMS, STEMS[0] + ".prm"),
                         tmp_path) == jax_cli_row


@pytest.mark.parametrize("stem", STEMS[1:])
def test_immersed_laplace_cli_rows(stem, tmp_path, monkeypatch):
    """The circle's and the square's rows equal the port's own problem run
    on the file (both packages solve their AL forms, exact and diagonal W,
    in ``test_torch_immersed_laplace_adaptive.py``)."""
    from fictitious_domain_al_preconditioners_torch.models import (
        ImmersedLaplaceConfig, ImmersedLaplaceProblem)

    monkeypatch.chdir(tmp_path)
    prm = os.path.join(PARAMS, stem + ".prm")
    rows = port_cli_rows(prm, tmp_path)
    prob = ImmersedLaplaceProblem(ImmersedLaplaceConfig.from_prm(prm),
                                  device="cpu").setup()
    prob.solve()
    assert prob.results["converged"]
    assert rows[1:] == [",".join(str(prob.results[k]) for k in (
        "dofs_background", "dofs_immersed", "outer_iterations"))]


def test_other_subcommands_run(tmp_path, monkeypatch):
    """elliptic_interface (one cycle), elasticity (background 2, immersed
    1), stokes with one local refinement step near Γ, stokes --3d and
    nitsche_bcs (two cycles) at lowered refinements."""
    monkeypatch.chdir(tmp_path)
    ell = prm_copy(tmp_path, "elliptic_interface_modified.prm",
                   [("Refinemented cycles           = 3",
                     "Refinemented cycles           = 1")])
    assert cli.main(["elliptic_interface", ell, "--device", "cpu"]) == 0
    for vtu in ("solution-background.vtu", "solution-immersed.vtu"):
        check_vtu(tmp_path / vtu)
    assert "EllipticInterfaceConfig" in \
        (tmp_path / "used_parameters.prm").read_text()

    el = prm_copy(tmp_path, "elasticity.prm",
                  [("Initial background refinement = 3",
                    "Initial background refinement = 2"),
                   ("Initial immersed refinement = 2",
                    "Initial immersed refinement = 1")], text=ELASTICITY_PRM)
    assert cli.main(["elasticity", el, "--device", "cpu"]) == 0

    st = prm_copy(tmp_path, "stokes_al.prm", [
        ("Initial background space refinement = 5",
         "Initial background space refinement = 3\n"
         "  set Local refinements steps near embedded domain = 1"),
        ("Initial embedded space refinement   = 6",
         "Initial embedded space refinement   = 5")])
    assert cli.main(["stokes", st, "--device", "cpu"]) == 0
    row = (tmp_path / "stokes_al.csv").read_text().splitlines()[1]
    assert int(row.split(",")[2]) > 0

    st3 = prm_copy(tmp_path, "stokes_al.prm", [
        ("<1,2>", "<2,3>"),
        ("Initial background space refinement = 5",
         "Initial background space refinement = 2"),
        ("Initial embedded space refinement   = 6",
         "Initial embedded space refinement   = 0"),
        ("Dirichlet boundary ids              = 0, 1, 2, 3",
         "Dirichlet boundary ids              = 0, 1, 2, 3, 4, 5"),
        ("= 1;1", "= 1;0;0"), ("= 0;0;0", "= 0;0;0;0"),
        ("= -.5;.5", "= -1;1;0")])
    os.rename(st3, tmp_path / "stokes_3d.prm")
    assert cli.main(["stokes", str(tmp_path / "stokes_3d.prm"), "--3d",
                     "--device", "cpu"]) == 0
    assert (tmp_path / "stokes_3d.csv").exists()

    ni = prm_copy(tmp_path, "nitsche.prm", [
        ("Number of refinement cycles        = 3",
         "Number of refinement cycles        = 2")])
    assert cli.main(["nitsche_bcs", ni, "--device", "cpu"]) == 0


def test_cli_loads_no_jax_and_needs_the_card_unless_asked(tmp_path,
                                                          jax_cli_row):
    """A whole run in a subprocess loads no ``jax`` module and writes the
    JAX package's row; without a card and without ``--device cpu`` the run
    fails instead of falling back to the CPU."""
    prm = os.path.join(PARAMS, STEMS[0] + ".prm")
    code = (
        "import sys\n"
        "from fictitious_domain_al_preconditioners_torch import cli\n"
        f"rc = cli.main(['immersed_laplace', {prm!r}, '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "jax = [m for m in sys.modules if m.split('.')[0] == 'jax']\n"
        "assert not jax, jax\n"
        "import torch\n"
        "if not torch.cuda.is_available():\n"
        f"    assert cli.main(['immersed_laplace', {prm!r}]) == 1\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
    assert (tmp_path / "flower_f1_g1.csv").read_text().splitlines() == \
        jax_cli_row


def test_export_matrix_csv_matches_jax(tmp_path):
    """``utils/vtu.py::export_matrix_csv`` writes the JAX package's file for
    a dense matrix and for triplets, and skips one larger than its limit."""
    import numpy as np

    from fictitious_domain_al_preconditioners_tpu.ops.sparse import \
        COO as JCOO
    from fictitious_domain_al_preconditioners_tpu.utils.vtu import \
        export_matrix_csv as jexport
    from fictitious_domain_al_preconditioners_torch.ops.sparse import \
        COO as TCOO
    from fictitious_domain_al_preconditioners_torch.utils.vtu import \
        export_matrix_csv as texport

    a = np.random.default_rng(0).standard_normal((4, 3))
    rows, cols = np.nonzero(a > 0)
    for name, (ja, ta) in {
            "dense": (a, a),
            "coo": (JCOO(rows, cols, a[rows, cols], a.shape),
                    TCOO(rows, cols, a[rows, cols], a.shape))}.items():
        assert jexport(str(tmp_path / f"j_{name}.csv"), ja)
        assert texport(str(tmp_path / f"t_{name}.csv"), ta)
        assert (tmp_path / f"t_{name}.csv").read_text() == \
            (tmp_path / f"j_{name}.csv").read_text()
    assert not texport(str(tmp_path / "big.csv"), a, limit=2)
