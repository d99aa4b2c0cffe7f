"""Benchmark of the PyTorch port (``fictitious_domain_al_preconditioners_torch``)
on one CUDA card: time to a converged solve of the immersed Laplace and
immersed Stokes problems, set-up time and peak device memory, each answer
judged against a plain float64 reference (``reference/``).

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json`` (its ``family`` names ``families/<family>.py``),
``traffic/<traffic>.json``, ``workloads/<cell>.json`` and
``metrics/<metric>.py``.  Run from the repository's root:

    python3 -m fdal_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The readings that the limits of ``correct`` come from: ``python3 -m
fdal_bench.control`` (on the card, never in a run).  Tests: ``python -m
pytest fdal_bench/tests -q -p no:cacheprovider`` on the CPU (tiny cells);
``python3 -m pytest -m gpu fdal_bench/tests -q -p no:cacheprovider`` on the
card.
"""
