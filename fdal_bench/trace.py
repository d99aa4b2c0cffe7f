"""The traced run: ``record_function`` ranges from the benchmark's own
code around its calls into the port (set-up, solver build, each solve, each
call of a kernel entry of ``ops/kernels.py``), ``torch.profiler`` over the
first solves of the window, and the reduction of its events to the device's
busy time, the device operations that took most time, the idle gaps by the
host range they fell in, and the device time of the kernel entries'
launches."""

from __future__ import annotations

import bisect
import collections
import sys
from dataclasses import dataclass, field

PREFIX = "fdal_bench."
WINDOW = PREFIX + "traced_window"
KERNEL_PREFIX = PREFIX + "kernel."
#: the kernel entries of ``ops/kernels.py``; the port binds them by name in
#: each module that calls them, so each such namespace is wrapped
KERNEL_ENTRIES = ("masked_laplace_2d", "laplace_stencil_2d",
                  "fused_augmented_2d")


def span(name: str):
    """A profiler range named ``fdal_bench.<name>`` (inert while no
    profiler records)."""
    import torch

    return torch.profiler.record_function(PREFIX + name)


class KernelCalls:
    """While installed, every call of a kernel entry runs inside a range
    ``fdal_bench.kernel.<entry>`` and is recorded with its shape, dtype,
    mode, patch box and degree (:func:`..roofline.call_bound_s` reads
    them)."""

    def __init__(self):
        self.calls = []
        self._patched = []

    def _wrap(self, name, fn):
        import torch

        calls = self.calls

        def wrapped(*args, **kwargs):
            if name == "fused_augmented_2d":
                mode, st, b = args[:3]
                rec = dict(kernel=name, mode=mode, shape=list(st.shape),
                           box=list(st.box), degree=kwargs.get("degree", 4),
                           dtype=str(b.dtype).replace("torch.", ""),
                           cuda=b.device.type == "cuda")
            else:
                u = args[0]
                rec = dict(kernel=name, shape=list(u.shape),
                           dtype=str(u.dtype).replace("torch.", ""),
                           cuda=u.device.type == "cuda")
            calls.append(rec)
            with torch.profiler.record_function(KERNEL_PREFIX + name):
                return fn(*args, **kwargs)

        return wrapped

    def install(self):
        from fictitious_domain_al_preconditioners_torch.ops import kernels

        for name in KERNEL_ENTRIES:
            orig = getattr(kernels, name)
            wrapped = self._wrap(name, orig)
            for mod in list(sys.modules.values()):
                if (getattr(mod, "__name__", "").startswith(
                        "fictitious_domain_al_preconditioners_torch")
                        and getattr(mod, name, None) is orig):
                    setattr(mod, name, wrapped)
                    self._patched.append((mod, name, orig))
        return self

    def uninstall(self):
        for mod, name, orig in self._patched:
            setattr(mod, name, orig)
        self._patched = []


# -- reduction ------------------------------------------------------------------

@dataclass
class Event:
    name: str
    start: float          # microseconds from the trace's start
    end: float
    corr: int = 0         # correlation id
    linked: int = 0       # the correlation id of the host op it belongs to
    thread: int = 0


@dataclass
class TraceData:
    """The reduced trace of a traced window."""

    window_s: float
    busy_s: float
    solves: int
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[host range, seconds]]
    kernel_calls: list = field(default_factory=list)   # those found launched
    kernel_device_s: float = 0.0
    kernel_launches: int = 0


def events_of(prof):
    """Plain device and host event lists of a finished ``torch.profiler``
    run, read from the profiler's raw (kineto) events: building its
    ``FunctionEvent`` tree costs about 70 µs an event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    device, host = [], []
    for evt in res.events():
        e = Event(evt.name(), (evt.start_ns() - t0) / 1e3,
                  (evt.end_ns() - t0) / 1e3, evt.correlation_id(),
                  evt.linked_correlation_id(), evt.start_thread_id())
        (device if evt.device_type() == cuda else host).append(e)
    return device, host


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, thread, times):
    """For each time, the names of the bench range and of the innermost host
    event on ``thread`` that cover it ('' where none)."""
    evs = sorted((e for e in host if e.thread == thread),
                 key=lambda e: (e.start, -e.end))
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [("", "")] * len(times)
    stack, bench, k = [], [], 0
    for i in order:
        t = times[i]
        while k < len(evs) and evs[k].start <= t:
            stack.append(evs[k])
            if evs[k].name.startswith(PREFIX) and evs[k].name != WINDOW:
                bench.append(evs[k])
            k += 1
        stack = [e for e in stack if e.end >= t]
        bench = [e for e in bench if e.end >= t]
        inner = stack[-1].name if stack else ""
        out[i] = (bench[-1].name[len(PREFIX):] if bench else "", inner)
    return out


def reduce(device, host, kernel_calls, top: int = 10) -> TraceData:
    """Busy and idle time, the leading device operations and idle gaps, and
    the kernel entries' device time inside the traced window (the host range
    ``fdal_bench.traced_window``)."""
    win = [e for e in host if e.name == WINDOW]
    if not win:
        raise ValueError("trace: no traced window range")
    w0, w1 = win[0].start, win[0].end
    thread = win[0].thread
    range_names = {e.name for e in host if e.name.startswith(PREFIX)}
    dev = [e for e in device if e.name not in range_names
           and e.end > w0 and e.start < w1]
    busy = _union([(max(e.start, w0), min(e.end, w1)) for e in dev])
    busy_us = sum(e - s for s, e in busy)

    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += (min(e.end, w1) - max(e.start, w0)) / 1e6
    device_ops = [[n[:160], s] for n, s in by_name.most_common(top)]

    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    names = _innermost(host, thread, [s for s, _ in gaps])
    by_gap = collections.Counter()
    for (s, e), (bench, inner) in zip(gaps, names):
        by_gap[f"{bench or 'harness'} / {inner or 'idle host'}"] += (e - s) / 1e6
    idle_gaps = [[n[:160], s] for n, s in by_gap.most_common(top)]

    # the device work launched inside the kernel entries' ranges: by the
    # launching runtime call's time, or by the host op the launch is linked
    # to; one range a recorded call, in call order
    ranges = sorted((e.start, e.end, e.corr) for e in host
                    if e.name.startswith(KERNEL_PREFIX)
                    and e.end > w0 and e.start < w1)
    starts = [r[0] for r in ranges]
    range_of_id = {r[2]: i for i, r in enumerate(ranges) if r[2]}
    launch_at = {e.corr: e.start for e in host
                 if e.corr and "Launch" in e.name}

    def range_of(e):
        t = launch_at.get(e.corr)
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ranges[i][1] >= t:
                return i
        return range_of_id.get(e.linked)

    per_range = [0.0] * len(ranges)
    k_n = 0
    for e in dev:
        i = range_of(e)
        if i is not None:
            per_range[i] += e.end - e.start
            k_n += 1
    calls = list(kernel_calls)
    if len(calls) == len(ranges):
        # a call whose launch the trace lost counts on neither side
        calls = [c for c, us in zip(calls, per_range) if us > 0]
    solves = sum(1 for e in host if e.name == PREFIX + "solve"
                 and e.start >= w0 and e.end <= w1)
    return TraceData(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                     solves=solves, device_ops=device_ops,
                     idle_gaps=idle_gaps, kernel_calls=calls,
                     kernel_device_s=sum(per_range) / 1e6,
                     kernel_launches=k_n)

