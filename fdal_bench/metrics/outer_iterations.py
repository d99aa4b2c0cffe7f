"""Outer Krylov iterations a solve, ``results["outer_iterations"]``, mean
over the window's solves."""


def read(run):
    return run.mean("outer_iterations")
