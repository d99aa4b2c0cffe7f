"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under this package a cell's workload, configuration,
traffic and family, and each metric's reader."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with everything it names."""

    name: str
    package_dir: str     # where the cell's files were found
    entry: dict          # BENCHMARK.json's workload entry
    workload: dict       # workloads/<cell>.json
    config: dict         # the configuration file
    traffic: dict        # traffic/<traffic>.json
    end_to_end: list     # metric entries reported with --trace 0
    per_layer: list      # metric entries reported with --trace 1

    def family(self):
        return importlib.import_module(
            f"fdal_bench.families.{self.config['family']}")

    def reader(self, metric_name: str):
        """The ``read(run)`` function of ``metrics/<name>.py`` (a dot in a
        metric's name is an underscore in its file's)."""
        stem = metric_name.replace(".", "_")
        path = os.path.join(self.package_dir, "metrics", f"{stem}.py")
        mod_spec = importlib.util.spec_from_file_location(
            f"fdal_bench.metrics.{stem}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT,
              package_dir: str = PACKAGE_DIR) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, its files under
    ``package_dir``."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[entry["config"]]
    return Cell(
        name=name, package_dir=package_dir, entry=entry,
        workload=_load_json(os.path.join(package_dir, "workloads",
                                         f"{name}.json")),
        config=_load_json(os.path.join(root, conf["file"])),
        traffic=_load_json(os.path.join(package_dir, "traffic",
                                        f"{entry['traffic']}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)])

