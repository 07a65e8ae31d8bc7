"""BENCHMARK.json and the files it names: every cell loads, the file keeps
to the contract's shape, and a cell, a span and a per-layer metric can be
added as new files plus new entries, with no file that exists edited."""

from __future__ import annotations

import json
import os
import re

from conftest import ROOT

from harness.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _data():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract_shape():
    d = _data()
    assert set(d) == KEYS
    assert d["paths"] == ["benchmark"] and 1 <= d["run_seconds"] <= 51
    assert d["command"] == ["python3", "benchmark/run.py"]
    names = [c["name"] for c in d["configs"]]
    cells = [w["name"] for w in d["workloads"]]
    metrics = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert {w["config"] for w in d["workloads"]} >= {c["name"]}
    pairs = {(w["config"], w["traffic"]) for w in d["workloads"]}
    assert len(pairs) == len(d["workloads"])
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in e2e
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_loads_from_its_files():
    spec = Spec()
    for w in spec.data["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.traffic["mode"] in ("chunked", "live")
        assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
        assert "setup_s" in {e["name"] for e in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for e in cell.per_layer:
            assert callable(spec.metric(e["name"]).read)
        for s in spec.spans([e["name"] for e in cell.per_layer]).values():
            assert ":" in s["target"]


def test_config_files_state_source_and_cuts():
    spec = Spec()
    for c in spec.data["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert cfg["assumed"] and cfg["camera"]["width"] > 0
        assert set(cfg["reduced"]) <= set(cfg)


def test_a_cell_span_and_metric_are_added_from_new_files_alone(bench_copy):
    root, before = bench_copy
    for path, blob in before.items():
        if os.path.basename(path) == "BENCHMARK.json":
            continue
        with open(path, "rb") as f:
            assert f.read() == blob, f"{path} was edited"
    spec = Spec(os.path.join(root, "BENCHMARK.json"), os.path.join(root, "benchmark"))
    cell = spec.cell("tiny_eao.chunked_tiny")
    assert cell.config["name"] == "tiny_eao" and cell.traffic["chunk"] == 8
    assert "passes_ms_per_frame.tiny" in [e["name"] for e in cell.per_layer]
    # a traced run wraps the spans its cell's metrics read, and no others
    assert set(spec.spans([e["name"] for e in cell.per_layer])) == {"all_passes"}
    live = spec.cell("tiny_eao.live_tiny")
    assert set(spec.spans([e["name"] for e in live.per_layer])) == set()
    # the accepted entries are all still there, unchanged
    old = _data()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert spec.data[key][:len(old[key])] == old[key]
