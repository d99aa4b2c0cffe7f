"""The trace's reduction and the per-layer readers on a synthetic profiler
table, and the frozen bound arithmetic against ``chip_smoke.py``'s."""

import pytest

import chip_smoke
from fdal_bench import roofline, spec
from fdal_bench.trace import KERNEL_PREFIX, PREFIX, WINDOW, Event, reduce
from fdal_bench.window import Run

K2 = dict(kernel="fused_augmented_2d", mode="pre", shape=[4097, 4097],
          box=[1000, 1100, 900, 800], degree=4, dtype="float32", cuda=True)
K1 = dict(kernel="masked_laplace_2d", shape=[2049, 2049], dtype="bfloat16",
          cuda=True)


def table():
    """A 100 µs window on thread 1: one solve holding two kernel-entry
    calls (their launches at 12 and 42 µs) and an ``aten::item`` sync; on
    the device the two kernels, a copy and an annotation."""
    host = [
        Event(WINDOW, 0, 100, 1, 0, 1),
        Event(PREFIX + "solve", 5, 95, 2, 0, 1),
        Event(KERNEL_PREFIX + "fused_augmented_2d", 10, 15, 3, 0, 1),
        Event("cudaLaunchKernel", 12, 13, 101, 3, 1),
        Event(KERNEL_PREFIX + "masked_laplace_2d", 40, 45, 4, 0, 1),
        Event("cudaLaunchKernel", 42, 43, 102, 4, 1),
        Event("aten::item", 60, 90, 5, 0, 1),
        Event("cudaMemcpyAsync", 61, 62, 103, 5, 1),
    ]
    device = [
        Event("sweep_kernel<2, 4, true>", 20, 30, 101, 3),
        Event("masked_laplace_kernel<__nv_bfloat16, 8>", 44, 50, 102, 4),
        Event("Memcpy DtoH", 70, 72, 103, 5),
        Event(PREFIX + "solve", 5, 95, 2, 0),        # a device annotation
    ]
    return device, host


def test_busy_idle_and_breakdown():
    device, host = table()
    t = reduce(device, host, [K2, K1])
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(18e-6)
    assert t.solves == 1
    assert t.device_ops[0] == ["sweep_kernel<2, 4, true>", pytest.approx(10e-6)]
    gaps = dict(t.idle_gaps)
    assert gaps["solve / aten::item"] == pytest.approx(28e-6)   # 72 -> 100
    # each gap goes to the host's innermost range where the device went idle
    assert gaps["harness / " + WINDOW] == pytest.approx(20e-6)  # 0 -> 20
    assert gaps["solve / " + PREFIX + "solve"] == pytest.approx(34e-6)
    assert t.kernel_launches == 2
    assert t.kernel_device_s == pytest.approx(16e-6)


def test_kernels_matched_by_linked_op_alone():
    device, host = table()
    host = [e for e in host if not e.name.startswith("cuda")]
    t = reduce(device, host, [K2, K1])
    assert t.kernel_launches == 2


def test_a_call_whose_launch_the_trace_lost_counts_on_neither_side():
    device, host = table()
    device = [e for e in device if not e.name.startswith("masked")]
    t = reduce(device, host, [K2, K1])
    assert t.kernel_calls == [K2]
    assert t.kernel_device_s == pytest.approx(10e-6)


def test_readers():
    device, host = table()
    run = Run(trace=reduce(device, host, [K2, K1]), peak_bytes=7_630_000_000,
              setup_s=21.5)
    cell = spec.load_cell("laplace_circle.r12_f32")
    assert cell.reader("device_idle_pct")(run) == pytest.approx(82.0)
    assert cell.reader("device_ms_per_solve")(run) == pytest.approx(0.018)
    bound = roofline.call_bound_s(K2) + roofline.call_bound_s(K1)
    assert cell.reader("kernel_roofline_pct")(run) == pytest.approx(
        100 * bound / 16e-6)
    assert cell.reader("peak_mem_gb")(run) == pytest.approx(7.63)
    assert cell.reader("setup_s")(run) == 21.5
    assert cell.reader("kernel_roofline_pct")(Run()) is None
    assert cell.reader("device_idle_pct")(Run()) is None


class _Stencil:
    def __init__(self, shape, box):
        self.shape, self.box = shape, box


@pytest.mark.parametrize("mode", ["op", "smooth", "pre", "post"])
@pytest.mark.parametrize("shape, box", [((4097, 4097), (1631, 1631, 835, 835)),
                                        ((65, 65), (0, 0, 0, 0)),
                                        ((5, 5), (1, 1, 3, 3))])
def test_fused_bound_as_chip_smoke(mode, shape, box):
    ms, _ = chip_smoke.fused_bound(mode, _Stencil(shape, box), 4)
    assert roofline.fused_bound_s(mode, shape, box, 4) * 1e3 == \
        pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("shape", [(4097, 4097), (2049, 2049), (5, 5)])
def test_stencil_bounds_as_chip_smoke(shape):
    n = shape[0] * shape[1]
    flops = chip_smoke.STENCIL_FLOPS * n
    assert roofline.stencil_bound_s(shape, "float32") * 1e3 == \
        pytest.approx(chip_smoke.bound(8 * n, flops)[0], rel=1e-12)
    assert roofline.stencil_bound_s(shape, "bfloat16") * 1e3 == \
        pytest.approx(chip_smoke.bound(4 * n, flops)[0], rel=1e-12)
    assert roofline.stencil_bound_s(shape, "float64") * 1e3 == pytest.approx(
        chip_smoke.bound(16 * n, flops, chip_smoke.F64_FLOP_PER_S)[0],
        rel=1e-12)
