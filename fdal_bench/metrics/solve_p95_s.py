"""95th percentile of the wall seconds of every request of the window
(host clock), where ten or more lie beyond it."""


def read(run):
    return run.solve_p95_s()
