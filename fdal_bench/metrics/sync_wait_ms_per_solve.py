"""Host milliseconds a solve spent in the Krylov solvers' device-to-host
reads (the program's ``krylov.sync`` spans: the wait for the device and
the copy), over the window's solves after the profiled ones."""


def read(run):
    sd = getattr(run, "spans", None)
    if sd is None or not sd.after_solves:
        return None
    return 1e3 * sd.sync_s_after / sd.after_solves
