"""Device-busy milliseconds (the union of the device's activities) over the
solves of the traced window (profiler)."""


def read(run):
    t = run.trace
    if t is None or not t.solves:
        return None
    return 1e3 * t.busy_s / t.solves
