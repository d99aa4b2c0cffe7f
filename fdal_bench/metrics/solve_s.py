"""Window seconds over the converged solves completed (host clock)."""


def read(run):
    return run.solve_s()
