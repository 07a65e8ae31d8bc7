"""The benchmark's data: ``BENCHMARK.json`` at the repository root and the
files it names by convention under ``benchmark/``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them, or to one span or per-layer metric,
is a file of its own, found by name:

    benchmark/configs/<config>.json    one deployment (camera, ORB, mode, capacities,
                                       the scene and the camera's trajectory)
    benchmark/traffic/<traffic>.json   one traffic mix (mode, chunk, the window's work)
    benchmark/limits/<cell>.json       the limits of the numbers that decide `correct`
    benchmark/spans/<span>.json        one program call that a traced run may wrap
    benchmark/metrics/<metric>.py      one per-layer metric's reader, with the
                                       names of the spans it reads (``SPANS``)

so a new cell, span or metric is new files plus new entries, and no file
that exists is edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list       # ... and with --trace 1


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the benchmark directory it refers to (both
    default to this checkout's)."""

    def __init__(self, benchmark_json: str = None, bench_dir: str = BENCH_DIR):
        self.bench_dir = bench_dir
        self.path = benchmark_json or os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json")
        self.data = _load_json(self.path)

    def _file(self, kind: str, name: str, ext: str = ".json") -> str:
        path = os.path.join(self.bench_dir, kind, name + ext)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                    f"file for {name!r}: {path}")
        return path

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        entry = next((c for c in self.data["configs"] if c["name"] == name), None)
        if entry is None:
            raise KeyError(f"no config {name!r} in {self.path}")
        return _load_json(os.path.join(os.path.dirname(self.path), entry["file"]))

    def traffic(self, name: str) -> dict:
        return _load_json(self._file("traffic", name))

    def limits(self, cell: str) -> dict:
        return _load_json(self._file("limits", cell))

    @staticmethod
    def _reported(entries: list, cell: str, moved: set = None) -> list:
        """The entries a cell reports: those whose ``workloads`` name it;
        without the key, every end-to-end metric (``moved`` None) and every
        per-layer metric that moves one the cell reports."""
        return [e for e in entries
                if (cell in e["workloads"] if "workloads" in e
                    else moved is None or e["moves"] in moved)]

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        e2e = self._reported(self.data["end_to_end"], name)
        names = {e["name"] for e in e2e}
        return Cell(name=name, config=self.config(w["config"]), traffic=self.traffic(w["traffic"]),
                    limits=self.limits(name), end_to_end=e2e,
                    per_layer=self._reported(self.data["per_layer"], name, names))

    def metric(self, name: str):
        """A per-layer metric's module: ``read(record)``, and ``SPANS``, the
        names of the span files whose times it reads (none if it has no
        ``SPANS``)."""
        path = self._file("metrics", name, ".py")
        mod_spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod

    def spans(self, metrics: list) -> dict:
        """The span files that the named per-layer metrics read: name -> spec.
        A traced run wraps these and no others, so a span that a later
        metric adds leaves the traced runs of other cells as they were."""
        names = sorted({s for m in metrics for s in getattr(self.metric(m), "SPANS", ())})
        return {n: _load_json(self._file("spans", n)) for n in names}
