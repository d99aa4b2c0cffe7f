"""Inner CG iterations a solve (the CGs on the V-cycle inside the AL
preconditioner, which set the number of V-cycles),
``results["inner_iterations"]``, mean over the window's solves."""


def read(run):
    return run.mean("inner_iterations")
