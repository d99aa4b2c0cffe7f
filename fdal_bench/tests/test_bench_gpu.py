"""Every cell end to end on the card at the tests' tiny size, traced and
not: correct, the kernel entries' launches all found in the trace, and no
share of a roofline above 100%."""

import pytest

from fdal_bench import run, spec

CELLS = ["laplace_circle.r12_f32", "stokes2d_circle.r9_10",
         "laplace_circle.r12_bf16"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(bench_root, card, name):
    import torch

    root, pkg = bench_root
    cell = spec.load_cell(name, root=root, package_dir=pkg)
    torch.cuda.set_device(card)
    for trace in (False, True):
        torch.cuda.reset_peak_memory_stats(card)
        r, checks, _ = run.run_cell(cell, 2 ** 31 + 17, 1.0, trace,
                                    device=card)
        out = run.result_line(cell, r, checks, trace, dict(platform="gpu"))
        assert out["correct"], checks
        assert r.peak_bytes > 0
    t = r.trace
    assert 0 < t.busy_s <= t.window_s
    calls = [c for c in t.kernel_calls if c["cuda"]]
    assert t.kernel_launches == len(calls)    # each found call launched one
    if "laplace" in name:
        assert calls and 0 < out["metrics"]["kernel_roofline_pct"]["value"] <= 100
