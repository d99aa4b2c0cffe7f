"""The kernel entries' share of their roofline in the traced window: the
sum over their calls on the card of the least time each call's work needs
(``roofline.call_bound_s``, at the call's recorded shape, dtype and mode)
over the device time of the kernels launched inside those calls' ranges
(profiler).  None where no kernel entry ran on the card."""

from fdal_bench.roofline import call_bound_s


def read(run):
    t = run.trace
    if t is None or t.kernel_device_s <= 0:
        return None
    calls = [c for c in t.kernel_calls if c["cuda"]]
    if not calls:
        return None
    return 100.0 * sum(call_bound_s(c) for c in calls) / t.kernel_device_s
