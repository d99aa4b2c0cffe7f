"""Outer counts of the elasticity interface problem in both packages, on the
CPU in float64: the results table's configuration
(``scripts/make_results_table.py:222-246``: 3D, fixed inner iterations,
W = M² exact, outer tolerance 3e-5 and reduction 1e-5) at one cycle, each
package on its own setup with the JAX package's Lanczos start vectors given
to the port.  Prints one JSON line: dofs, the two outer counts, the two
solve seconds and the relative max-norm difference of the block solutions.

    python3 elasticity_parity.py --cycle 2 [--degree 2]

Cycle 2 (107,811 + 2,187 + 2,187 dofs) takes tens of minutes a package on
one CPU core.  Needs jax (CPU) beside torch; it is a check, not part of
the port.
"""

import argparse
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from fictitious_domain_al_preconditioners_tpu.models import \
    elasticity as jel  # noqa: E402
from fictitious_domain_al_preconditioners_torch.models import \
    elasticity as tel  # noqa: E402


def table_config(mod, degree):
    cfg = mod.ElasticityInterfaceConfig(use_fixed_iterations=True,
                                        background_space_degree=degree)
    cfg.outer.tolerance = 3e-5
    cfg.outer.reduction = 1e-5
    return cfg


def jax_normal(n):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                        dtype=jnp.float64))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cycle", type=int, default=2)
    ap.add_argument("--degree", type=int, default=1,
                    help="background element degree")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    t0 = time.perf_counter()
    jp = jel.ElasticityInterfaceProblem(table_config(jel, args.degree))
    jp.setup(args.cycle)
    jp.solve()
    jax_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    tp = tel.ElasticityInterfaceProblem(table_config(tel, args.degree),
                                        device="cpu")
    tp.lanczos_start = tp.lanczos_start_a22 = lambda i, n: jax_normal(n)
    tp.setup(args.cycle)
    tp.solve()
    port_s = time.perf_counter() - t0

    xj = np.concatenate([np.asarray(x) for x in (jp.u, jp.u2, jp.lam)])
    xt = np.concatenate([x.numpy() for x in (tp.u, tp.u2, tp.lam)])
    print(json.dumps(dict(
        cycle=args.cycle, degree=args.degree, dofs=list(tp.layout.sizes),
        jax_outer=jp.results["outer_iterations"],
        port_outer=tp.results["outer_iterations"],
        jax_converged=bool(jp.results["converged"]),
        port_converged=bool(tp.results["converged"]),
        jax_seconds=jax_s, port_seconds=port_s,
        rel_diff=float(np.abs(xt - xj).max() / np.abs(xj).max()),
        gmg_routes=tp.results["gmg_routes"])), flush=True)


if __name__ == "__main__":
    main()
