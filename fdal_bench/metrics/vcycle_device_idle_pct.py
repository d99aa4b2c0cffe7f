"""Share of the GMG V-cycles' time (the program's ``gmg.vcycle`` spans of
the profiled solves) in which the device did nothing (profiler)."""


def read(run):
    sd = getattr(run, "spans", None)
    if sd is None or sd.vcycle_s_profiled <= 0:
        return None
    return 100.0 * sd.vcycle_idle_s / sd.vcycle_s_profiled
