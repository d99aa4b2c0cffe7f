"""One run of one cell of ``BENCHMARK.json`` on one CUDA card:

    python3 -m fdal_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up: the port's kernel library (built once into ``build/`` inside the
checkout, its compile recorded apart), the problem through the port's
entry (``setup()``), the load vectors of the traffic's modes, and one warm
solve that builds the solver.  Window: a closed loop with one caller, each
request one call of the cell's entry on data drawn from the seed, whole
solves until ``--seconds`` have passed.  Then the device's peak memory is
read, the program freed, and a sample of the window's answers (drawn from
the seed) judged against the float64 reference.  The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the last key of that object.

With ``--trace 1`` the run records ``torch.profiler`` over the window's
first solves and prints the cell's per-layer metrics instead of its
end-to-end ones."""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

from . import spec
from .trace import KernelCalls, events_of, reduce, span, WINDOW
from .traffic import Requests, sample_indices
from .window import Run

FORBIDDEN = {"jax", "jaxlib", "flax", "fictitious_domain_al_preconditioners_tpu"}


def process_age_s() -> float | None:
    """Seconds since this process started (Linux ``/proc``), or None."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_T0 = time.perf_counter() - (process_age_s() or 0.0)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that this benchmark may not load
    (JAX, and the JAX package whose name the port's begins with)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def cpu_jiffies() -> list:
    """The host's summed CPU times (``/proc/stat``: user, nice, system,
    idle, iowait, irq, softirq, steal), or [] where it cannot be read."""
    try:
        with open("/proc/stat") as fh:
            return [int(x) for x in fh.readline().split()[1:9]]
    except (OSError, ValueError):
        return []


def host_state(before: list, after: list) -> dict:
    """What the host did over a window, for reading a run's spread: load,
    the shares of CPU time busy and stolen by other guests, the cores'
    clocks and governor."""
    state = dict(loadavg=os.getloadavg())
    if len(before) == len(after) == 8 and sum(after) > sum(before):
        d = [b - a for a, b in zip(before, after)]
        state.update(busy_pct=100.0 * (sum(d) - d[3] - d[4]) / sum(d),
                     steal_pct=100.0 * d[7] / sum(d))
    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(line.split(":")[1]) for line in fh
                   if line.startswith("cpu MHz")]
        state["cpu_mhz"] = sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError):
        pass
    try:
        with open("/sys/devices/system/cpu/cpu0/cpufreq/scaling_governor") as fh:
            state["governor"] = fh.read().strip()
    except OSError:
        state["governor"] = None
    return state


def build_libraries(uses_kernels: bool) -> dict:
    """Load the port's host set-up library and, where the family runs them,
    its CUDA kernels, building them into ``build/`` inside the checkout on
    its first run: the seconds the loads took, and whether any compiled.
    The compile is part of ``setup_s`` (a checkout's first run pays it) and
    is reported apart beside it."""
    from fictitious_domain_al_preconditioners_torch import native
    from fictitious_domain_al_preconditioners_torch.ops import kernels

    libs = [(native, os.path.join(
        native.BUILD_DIR, f"libfdal_setup_{native.source_tag()}.so"))]
    if uses_kernels:
        libs.append((kernels, os.path.join(
            kernels.BUILD_DIR, f"libfdal_kernels_{kernels.source_tag()}.so")))
    compiled = [mod.__name__ for mod, lib in libs if not os.path.exists(lib)]
    t0 = time.perf_counter()
    for mod, _ in libs:
        mod._library()
    return dict(libraries_s=time.perf_counter() - t0, compiled=compiled)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda") -> tuple:
    """Set-up, window and check of one run: ``(Run, checks, stages)``, the
    last the seconds of set-up's stages and of the check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fam = cell.family()
    cuda = torch.device(device).type == "cuda"
    stages = dict(before_run_s=time.perf_counter() - _T0)
    stages.update(build_libraries(
        cuda and getattr(fam, "USES_KERNELS", False)))
    wl, modes = cell.workload, cell.traffic["modes"]
    drv = fam.Driver(cell.config, device)
    t0 = time.perf_counter()
    with span("setup"):
        drv.setup()
        t1 = time.perf_counter()
        drv.prepare(modes)
    t2 = time.perf_counter()
    requests = Requests(cell.traffic, seed)
    # the warm solve builds the solver, on the file's own data (mode 0)
    warm = [1.0] + [0.0] * (len(modes) - 1)
    with span("solver_build"):
        drv.set_data(warm)
        drv.solve()
    t3 = time.perf_counter()
    stages.update(setup_s=t1 - t0, prepare_s=t2 - t1, warm_solve_s=t3 - t2)
    run = Run(setup_s=time.perf_counter() - _T0,
              compile_s=stages["libraries_s"] if stages["compiled"] else 0.0,
              problem_setup_s=drv.prob.results["setup_seconds"],
              solver_build_s=drv.build_seconds())

    sample = set(sample_indices(seed, wl["trace_solves"], wl["sample_horizon"],
                                wl["sample"]))
    kept = {}
    prof = kernel_calls = window_range = None
    if trace:
        kernel_calls = KernelCalls().install()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        if cuda:
            torch.cuda.synchronize(device)
        window_range = torch.profiler.record_function(WINDOW)
        window_range.__enter__()

    def close_trace():
        nonlocal window_range
        if window_range is not None:
            window_range.__exit__(None, None, None)
            prof.stop()
            kernel_calls.uninstall()
            window_range = None

    jiffies = cpu_jiffies()
    try:
        start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            with span("request"):
                drv.set_data(requests.weights(i))
                with span("solve"):
                    answer, rec = drv.solve()
            t1 = time.perf_counter()
            rec["seconds"] = t1 - t0
            run.requests.append(rec)
            if i in sample:
                kept[i] = (tuple(a.detach().cpu() for a in answer),
                           rec["reported_residual"])
            del answer
            i += 1
            if trace and i == wl["trace_solves"]:
                close_trace()
            if t1 - start >= seconds:
                break
        run.window_s = t1 - start
        stages["host"] = host_state(jiffies, cpu_jiffies())
    finally:
        if trace:
            close_trace()
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if trace:
        run.trace = reduce(*events_of(prof), kernel_calls.calls)
        del prof
    t4 = time.perf_counter()
    checks = judge(fam, cell, requests, kept, device)
    stages["check_s"] = time.perf_counter() - t4
    return run, checks, stages


def judge(fam, cell, requests, kept: dict, device) -> dict:
    """The numbers compared, each worst over the sampled answers, beside
    their limits: ``residual_ratio`` = ‖b - 𝒜x‖ / threshold, the answer's
    float64 residual in the reference's system over the configuration's
    stopping threshold max(tolerance, reduction·‖b‖); ``residual_gap`` =
    |‖b - 𝒜x‖ - the residual the program reported| / threshold."""
    ref = fam.Driver.reference_class(cell.config["problem"],
                                     cell.traffic["modes"], device)
    ratio = gap = 0.0
    for i, (answer, reported) in sorted(kept.items()):
        res, thr = ref.judge(answer, requests.weights(i))
        ratio = max(ratio, res / thr)
        gap = max(gap, abs(res - reported) / thr)
    values = dict(residual_ratio=ratio, residual_gap=gap)
    checks = {name: dict(value=values[name], limit=limit)
              for name, limit in cell.workload["limits"].items()}
    checks["answers"] = dict(value=len(kept), limit=1)
    return checks


def passed(checks: dict) -> bool:
    ok = checks["answers"]["value"] >= checks["answers"]["limit"]
    return ok and all(c["value"] <= c["limit"]
                      for name, c in checks.items() if name != "answers")


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result_line(cell, run: Run, checks: dict, trace: bool, device_info):
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    out = dict(correct=passed(checks), attempted=run.attempted,
               failed=run.failed, metrics=metrics, device=device_info)
    if trace:
        out["device"] = dict(device_info, busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = dict(device_ops=run.trace.device_ops,
                                idle_gaps=run.trace.idle_gaps)
    out["compile_s"] = run.compile_s
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    # the system under test first: without it no run can start
    import fictitious_domain_al_preconditioners_torch  # noqa: F401
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fdal_bench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.cuda.reset_peak_memory_stats(0)
    run, checks, stages = run_cell(cell, args.seed & (2 ** 64 - 1),
                                  args.seconds, bool(args.trace),
                                  device="cuda:0")
    found = forbidden_modules()
    if found:
        print(f"fdal_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    device_info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                       count=chips, memory_peak_bytes=run.peak_bytes,
                       power_limit_w=power_limit_w())
    out = result_line(cell, run, checks, bool(args.trace), device_info)
    times = sorted(r["seconds"] for r in run.requests)
    print(json.dumps(dict(stages=stages, setup_s=run.setup_s,
                          solves=run.attempted,
                          request_s_median=times[len(times) // 2],
                          outer_iterations_mean=run.mean("outer_iterations"),
                          kernel_calls_traced=(len(run.trace.kernel_calls)
                                               if run.trace else None),
                          kernel_launches_matched=(run.trace.kernel_launches
                                                   if run.trace else None))),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
