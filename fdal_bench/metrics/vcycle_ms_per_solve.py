"""Host milliseconds a solve inside the GMG V-cycles (the program's
``gmg.vcycle`` spans), over the window's solves after the profiled ones."""


def read(run):
    sd = getattr(run, "spans", None)
    if sd is None or not sd.after_solves:
        return None
    return 1e3 * sd.vcycle_s_after / sd.after_solves
