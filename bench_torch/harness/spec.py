"""Where each piece of the benchmark is found, by the name that
``BENCHMARK.json`` gives it.

* a cell: its entry in ``workloads``;
* a configuration: the JSON file that its ``configs`` entry names;
* a traffic mix: ``bench_torch/traffic/<name>.json``;
* a per-layer metric: ``bench_torch/metrics/<name>.py``, a reader with
  ``read(ctx)``;
* the limits of a cell's comparison: ``bench_torch/limits/<cell>.json``.

A later cell, configuration, traffic mix or metric is a new file and a new
entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files it
    names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "bench_torch"
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def cell(self, workload: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == workload:
                return w
        names = ", ".join(w["name"] for w in self.bench["workloads"])
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({names})")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(self.bench_dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return _json(self.bench_dir / "limits" / f"{workload}.json")

    def end_to_end(self, workload: str) -> list:
        """The end-to-end metrics that ``workload`` reports."""
        return [m for m in self.bench["end_to_end"] if _in(m, workload)]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics that ``workload`` reports."""
        return [m for m in self.bench["per_layer"] if _in(m, workload)]

    def reader(self, metric: str):
        """The module of ``metrics/<metric>.py``, loaded by path (a metric's
        name may hold dots)."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        if spec is None or not path.is_file():
            raise FileNotFoundError(f"no reader {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def _in(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)
