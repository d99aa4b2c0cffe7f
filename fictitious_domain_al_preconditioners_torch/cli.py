"""Command-line drivers of the PyTorch port: the reference's executables,
one subcommand each (``./<exe> <file>.prm``, immersed_laplace.cc:1046-1088):

    python -m fictitious_domain_al_preconditioners_torch.cli immersed_laplace <file>.prm
    python -m fictitious_domain_al_preconditioners_torch.cli elliptic_interface <file>.prm
    python -m fictitious_domain_al_preconditioners_torch.cli elasticity <file>.prm
    python -m fictitious_domain_al_preconditioners_torch.cli stokes <file>.prm [--3d]
    python -m fictitious_domain_al_preconditioners_torch.cli nitsche_bcs <file>.prm

    options: --device cuda|cpu (default cuda)

Counterpart of ``fictitious_domain_al_preconditioners_tpu.cli``.  Each run
echoes the resolved configuration to ``used_parameters.prm``
(immersed_laplace.cc:1063), appends a results row (dofs_background,
dofs_immersed, outer_iterations) to ``<prm-stem>.csv`` for
immersed_laplace and stokes, and writes VTU output.  The problem runs on
the CUDA card unless ``--device cpu`` is given, and then in float64, the
reference's precision; on the card the solves run in float32.  Without a
card and without ``--device cpu`` the run fails: nothing falls back to the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

__all__ = ["main"]


def _echo_used_parameters(cfg):
    """Write used_parameters.prm with the resolved configuration."""
    from .utils.prm import dump_prm

    def to_tree(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f.name] = to_tree(v) if dataclasses.is_dataclass(v) else str(v)
        return out

    with open("used_parameters.prm", "w") as fh:
        fh.write(dump_prm({type(cfg).__name__: to_tree(cfg)}) + "\n")


def _results_row(prm_path: str, prob):
    from .utils.report import append_results_csv

    stem = os.path.splitext(os.path.basename(prm_path))[0]
    append_results_csv(f"{stem}.csv", {
        "dofs_background": prob.results["dofs_background"],
        "dofs_immersed": prob.results["dofs_immersed"],
        "outer_iterations": prob.results["outer_iterations"]})


def run_immersed_laplace(prm_path: str, device):
    from .models import ImmersedLaplaceConfig, ImmersedLaplaceProblem
    from .utils.vtu import write_vtu_background, write_vtu_immersed

    cfg = ImmersedLaplaceConfig.from_prm(prm_path)
    _echo_used_parameters(cfg)
    prob = ImmersedLaplaceProblem(cfg, device=device).setup()
    prob.solve()
    print(f"Background dofs: {prob.results['dofs_background']}, "
          f"immersed dofs: {prob.results['dofs_immersed']}")
    print(f"Outer iterations: {prob.results['outer_iterations']} "
          f"(converged={prob.results['converged']})")
    print(f"Constraint residual: {prob.constraint_residual():.3e}")
    _results_row(prm_path, prob)
    if prob.space.n_dofs < 2e6:
        write_vtu_background("solution_background.vtu", prob.space,
                             {"u": prob.u})
        write_vtu_immersed("multiplier.vtu", prob.imm_space,
                           {"lambda": prob.lam})
    print(prob.timer.summary())
    return prob


def run_elliptic_interface(prm_path: str, device):
    from .models import EllipticInterfaceConfig, EllipticInterfaceProblem
    from .utils.vtu import write_vtu_background, write_vtu_immersed

    cfg = EllipticInterfaceConfig.from_prm(prm_path)
    _echo_used_parameters(cfg)
    prob = EllipticInterfaceProblem(cfg, device=device)
    print(prob.run().render())
    if prob.space.n_dofs < 1e6:
        write_vtu_background(
            os.path.join(cfg.output_directory, "solution-background.vtu"),
            prob.space, {"u": prob.u})
        write_vtu_immersed(
            os.path.join(cfg.output_directory, "solution-immersed.vtu"),
            prob.fg_space, {"u2": prob.u2, "lambda": prob.lam})
    print(prob.timer.summary())
    return prob


def run_elasticity(prm_path: str, device):
    from .models import ElasticityInterfaceConfig, ElasticityInterfaceProblem

    cfg = ElasticityInterfaceConfig.from_prm(prm_path)
    _echo_used_parameters(cfg)
    prob = ElasticityInterfaceProblem(cfg, device=device).setup()
    its = prob.solve()
    print(f"Outer iterations: {its} (converged={prob.results['converged']})")
    print(f"Constraint residual: {prob.constraint_residual():.3e}")
    print(prob.timer.summary())
    return prob


def run_stokes(prm_path: str, device, spacedim: int = 2):
    from .models import StokesConfig, StokesProblem

    cfg = StokesConfig.from_prm(prm_path, spacedim=spacedim)
    _echo_used_parameters(cfg)
    prob = StokesProblem(cfg, device=device).setup()
    prob.solve()
    print(f"Outer iterations: {prob.results['outer_iterations']} "
          f"(converged={prob.results['converged']})")
    _results_row(prm_path, prob)
    print(prob.timer.summary())
    return prob


def run_nitsche(prm_path: str, device):
    from .models import NitscheConfig, NitscheProblem

    cfg = NitscheConfig.from_prm(prm_path)
    _echo_used_parameters(cfg)
    prob = NitscheProblem(cfg, device=device)
    table = prob.run()
    print("\nRefinement study summary:")
    print(table.render())
    print(prob.timer.summary())
    return prob


COMMANDS = {"immersed_laplace": run_immersed_laplace,
            "elliptic_interface": run_elliptic_interface,
            "elasticity": run_elasticity,
            "stokes": run_stokes,
            "nitsche_bcs": run_nitsche}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fictitious_domain_al_preconditioners_torch.cli",
        description="Run one problem of the port on a parameter file.")
    ap.add_argument("problem", choices=sorted(COMMANDS))
    ap.add_argument("prm", help="parameter file")
    ap.add_argument("--3d", dest="three_d", action="store_true",
                    help="stokes: the <2,3> instantiation (a sphere in the "
                         "unit cube)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the problem runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print("[fdal] running on CUDA in float32; tolerances below ~1e-7 "
              "are unreachable in single precision")
    try:
        if args.problem == "stokes":
            run_stokes(args.prm, args.device,
                       spacedim=3 if args.three_d else 2)
        else:
            COMMANDS[args.problem](args.prm, args.device)
    except Exception as exc:  # the reference's top-level try/catch
        print("----------------------------------------------------")
        print(f"Exception on processing:\n{exc}\nAborting!")
        print("----------------------------------------------------")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
