"""The share of the kernel entries' work that ran inside CUDA graph
replays, where ``kernel_roofline_pct`` cannot see it (a replay passes no
kernel-entry range): the least time (``roofline.call_bound_s``) of the
replayed calls over that of all kernel-entry calls on the card, each a mean
a solve.  The replayed calls are the program's own count by call record
(``ops.kernels.GRAPH_CALLS``), over the run's solves, the warm one
included; the others are the traced window's recorded calls.  None where
the program keeps no such count or no kernel entry ran on the card."""

from fdal_bench.roofline import call_bound_s


def read(run):
    from fictitious_domain_al_preconditioners_torch.ops import kernels

    replayed = getattr(kernels, "GRAPH_CALLS", None)
    t = run.trace
    if replayed is None or t is None or not t.solves:
        return None
    graph = sum(n * call_bound_s(dict(rec)) for rec, n in replayed.items())
    graph /= run.attempted + 1
    eager = sum(call_bound_s(c) for c in t.kernel_calls if c["cuda"])
    eager /= t.solves
    if graph + eager <= 0:
        return None
    return 100.0 * graph / (graph + eager)
