"""Host syncs a solve, ``results["host_syncs"]``, mean over the window's
solves."""


def read(run):
    return run.mean("host_syncs")
