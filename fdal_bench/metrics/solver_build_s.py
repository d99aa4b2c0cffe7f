"""The port's solver build seconds, ``results["build_seconds"]`` (the GMG
hierarchy and its Lanczos bounds)."""


def read(run):
    return run.solver_build_s
