"""Cells driven by files alone: every cell of BENCHMARK.json runs end to
end on the CPU at a tiny size, and a new cell, configuration, traffic and
per-layer metric are added by files and entries only."""

import json
import os

import pytest

from fdal_bench import run, spec

CELLS = ["laplace_circle.r12_f32", "stokes2d_circle.r9_10",
         "laplace_circle.r12_bf16"]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_and_is_correct(bench_root, name):
    root, pkg = bench_root
    cell = spec.load_cell(name, root=root, package_dir=pkg)
    r, checks, _ = run.run_cell(cell, 2 ** 31 + 99, 0.5, False, device="cpu")
    out = run.result_line(cell, r, checks, False, dict(platform="cpu"))
    assert out["correct"], checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {"solve_s", "setup_s"} <= set(out["metrics"])
    names = {m["name"] for m in cell.end_to_end}
    assert ("solve_p95_s" in names) == (name == "laplace_circle.r12_f32")


def test_traced_run_reports_per_layer_metrics(bench_root):
    root, pkg = bench_root
    cell = spec.load_cell("laplace_circle.r12_f32", root=root, package_dir=pkg)
    r, checks, _ = run.run_cell(cell, 11, 0.3, True, device="cpu")
    out = run.result_line(cell, r, checks, True, dict(platform="cpu"))
    assert out["correct"]
    # counters of the program; no device on the CPU, so no device metric
    # reads a share of work done there
    for name in ("problem_setup_s", "solver_build_s", "outer_iterations",
                 "host_syncs_per_solve"):
        assert out["metrics"][name]["value"] > 0
    assert "kernel_roofline_pct" not in out["metrics"]
    # the plain kernels on the CPU launch nothing on a device
    assert r.trace.kernel_launches == 0 and r.trace.kernel_calls == []
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_by_files_alone(bench_root):
    """A dummy configuration (the Laplace circle moved), traffic (two of
    the modes, weighed afresh for each request), cell and per-layer metric:
    files and entries only."""
    root, pkg = bench_root
    with open(os.path.join(pkg, "configs", "laplace_circle.json")) as fh:
        cfg = json.load(fh)
    cfg["problem"]["embedded_configuration"][1] = "R=.2, Cx=.5, Cy=.5"
    with open(os.path.join(pkg, "configs", "dummy_circle.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pkg, "traffic", "laplace_modes.json")) as fh:
        traffic = json.load(fh)
    traffic = dict(pool=4, modes=traffic["modes"][:2])
    with open(os.path.join(pkg, "traffic", "two_modes.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(pkg, "workloads", "dummy_circle.fixed.json"), "w") as fh:
        json.dump(dict(sample=1, sample_horizon=1,
                       trace_solves=0, limits=dict(residual_ratio=10.0)), fh)
    with open(os.path.join(pkg, "metrics", "solves_traced.py"), "w") as fh:
        fh.write("def read(run):\n    return run.trace.solves if run.trace else None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append(dict(name="dummy_circle", source="test",
                                 file="fdal_bench/configs/dummy_circle.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="dummy_circle.fixed",
                                   config="dummy_circle", traffic="two_modes",
                                   chips=1, why="test"))
    bench["per_layer"].append(dict(name="solves_traced", unit="solves",
                                   better="higher", source="program_span",
                                   layer="device", moves="solve_s",
                                   workloads=["dummy_circle.fixed"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    cell = spec.load_cell("dummy_circle.fixed", root=root, package_dir=pkg)
    r, checks, _ = run.run_cell(cell, 5, 0.2, True, device="cpu")
    out = run.result_line(cell, r, checks, True, dict(platform="cpu"))
    assert out["correct"] and out["metrics"]["solves_traced"]["value"] >= 1
    assert list(out["checks"]) == ["residual_ratio", "answers"]
    # the new metric is not reported in the cells it does not list
    other = spec.load_cell("laplace_circle.r12_f32", root=root, package_dir=pkg)
    assert "solves_traced" not in {m["name"] for m in other.per_layer}


def test_compile_is_reported_apart(bench_root, monkeypatch):
    """A build of the libraries is timed, named and reported beside
    ``setup_s`` (which holds it, as a checkout's first run pays it)."""
    root, pkg = bench_root
    cell = spec.load_cell("stokes2d_circle.r9_10", root=root, package_dir=pkg)
    for compiled, expect in ((["native"], 3.25), ([], 0.0)):
        monkeypatch.setattr(run, "build_libraries", lambda uses_kernels, c=compiled:
                            dict(libraries_s=3.25, compiled=c))
        r, checks, stages = run.run_cell(cell, 3, 0.1, False, device="cpu")
        out = run.result_line(cell, r, checks, False, dict(platform="cpu"))
        assert stages["compiled"] == compiled
        assert out["compile_s"] == r.compile_s == expect
        assert list(out)[-1] == "checks"


def test_build_libraries_names_what_it_compiled(tmp_path, monkeypatch):
    from fictitious_domain_al_preconditioners_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_library", lambda: None)
    assert run.build_libraries(False)["compiled"] == [native.__name__]
    open(os.path.join(tmp_path, f"libfdal_setup_{native.source_tag()}.so"),
         "w").close()
    assert run.build_libraries(False)["compiled"] == []


def test_the_bf16_configuration_differs_only_in_its_v_cycle():
    """``laplace_circle_bf16`` is ``laplace_circle`` with the V-cycle in
    bfloat16: apart from that key and the provenance, the files agree."""
    def load(name):
        with open(os.path.join(spec.PACKAGE_DIR, "configs", f"{name}.json")) as fh:
            return json.load(fh)

    f32, bf16 = load("laplace_circle"), load("laplace_circle_bf16")
    assert f32["problem"].pop("use_bf16_multigrid") is False
    assert bf16["problem"].pop("use_bf16_multigrid") is True
    assert bf16["assumed"].pop("use_bf16_multigrid")
    for key in ("source", "deployment"):       # the provenance
        assert f32.pop(key) != bf16.pop(key)
    assert f32 == bf16
