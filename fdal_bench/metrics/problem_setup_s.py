"""The port's own set-up seconds, ``results["setup_seconds"]`` (host setup:
grid, curve, assembly, coupling)."""


def read(run):
    return run.problem_setup_s
