"""Device milliseconds a solve of the operations launched inside the
program's ``coupling.mv`` / ``coupling.rmv`` spans (C and Cᵀ), over the
profiled solves (profiler)."""


def read(run):
    sd = getattr(run, "spans", None)
    if sd is None or not sd.profiled_solves:
        return None
    return 1e3 * sd.coupling_device_s / sd.profiled_solves
