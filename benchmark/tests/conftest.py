"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark's
files in a temporary directory, with a tiny cell added from new files
alone (a configuration, a traffic mix, its limits, a span and a per-layer
metric), and a runner of that copy's cells on the CPU.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {
    "name": "tiny_eao",
    "source": "the benchmark's tests",
    "camera": {"fx": 267.7, "fy": 269.6, "cx": 160.05, "cy": 123.8, "width": 320, "height": 240,
               "fps": 30.0},
    "flag": "EAO",
    "port": {"orb": {"n_levels": 6},
             "capacity": {"max_keyframes": 32, "max_points": 4096, "max_objects": 8,
                          "max_features": 384, "max_boxes": 4, "local_ba_points": 1024}},
    "scene": {"seed": 5, "n_landmarks": 200, "n_objects": 4, "obj_z_range": [4.0, 5.2],
              "obj_size_range": [0.4, 0.9]},
    "trajectory": {"n_frames": 48, "radius": 2.0, "target": [0.0, 0.0, 4.5], "sweep_deg": 12.0,
                   "bob": 0.2, "bob_cycles": 0.6, "speed_wave": 0.4, "speed_cycles": 0.6},
    "assumed": [], "reduced": [],
}
TINY_TRAFFIC = {
    "chunked_tiny": {"mode": "chunked", "chunk": 8, "boxes": True, "window_fps": 4.0},
    "live_tiny": {"mode": "live", "start_frame": 8, "boxes": True, "window_fps": 3.0},
}
TINY_LIMITS = {"frontend_kp_diff": 0.0, "frontend_desc_diff": 0.0, "untracked_share": 0.1,
               "motion_rot_err_deg": 1.5, "motion_dir_err_deg": 40.0, "trajectory_err_share": 0.5}
NEW_SPAN = {"target": "eao_slam_torch.runtime.scan_tracker:ChunkedTracker._between_chunk_passes"}
NEW_METRIC = '''"""All between-chunk passes as one span, ms per frame of the window."""

SPANS = ("all_passes",)


def read(rec):
    t = rec["spans"].get("all_passes")
    return None if not t else 1e3 * sum(t) / rec["window"]["frames"]
'''


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def add_tiny_cells(root: str) -> list:
    """Add the tiny cells to the benchmark copy under ``root`` as new files
    and new entries; returns the paths of the files written."""
    b = os.path.join(root, "benchmark")
    new = [os.path.join(b, "configs", "tiny_eao.json"),
           os.path.join(b, "spans", "all_passes.json"),
           os.path.join(b, "metrics", "passes_ms_per_frame.tiny.py")]
    _write_json(new[0], TINY_CONFIG)
    _write_json(new[1], NEW_SPAN)
    with open(new[2], "w") as f:
        f.write(NEW_METRIC)
    for traffic, spec in TINY_TRAFFIC.items():
        path = os.path.join(b, "traffic", traffic + ".json")
        _write_json(path, spec)
        lim = os.path.join(b, "limits", f"tiny_eao.{traffic}.json")
        _write_json(lim, TINY_LIMITS)
        new += [path, lim]
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        data = json.load(f)
    data["configs"].append({"name": "tiny_eao", "source": "tests",
                            "file": "benchmark/configs/tiny_eao.json", "reduced": [],
                            "why": "a cell the CPU can run"})
    for traffic in TINY_TRAFFIC:
        data["workloads"].append({"name": f"tiny_eao.{traffic}", "config": "tiny_eao",
                                  "traffic": traffic, "chips": 1, "why": "tests"})
    data["per_layer"].append({"name": "passes_ms_per_frame.tiny", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "between-chunk passes",
                              "moves": "fps", "workloads": ["tiny_eao.chunked_tiny"]})
    _write_json(os.path.join(root, "BENCHMARK.json"), data)
    return new


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory):
    """(root of the copy, {path: bytes} of every file the copy had before the
    tiny cells were added)."""
    root = str(tmp_path_factory.mktemp("bench"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for d in ("configs", "traffic", "limits", "spans", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, "benchmark", d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    before = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                before[path] = f.read()
    add_tiny_cells(root)
    return root, before


@pytest.fixture(scope="session")
def run_tiny(bench_copy):
    """run_tiny(cell, seed, seconds, trace=False, patch=None) -> (result,
    check lines): one run of a cell of the copy on the CPU."""
    from harness.runner import run_cell
    from harness.spec import Spec

    import torch

    torch.set_num_threads(2)
    root, _ = bench_copy
    spec = Spec(os.path.join(root, "BENCHMARK.json"), os.path.join(root, "benchmark"))

    def run(cell, seed, seconds, trace=False, patch=None):
        return run_cell(spec, cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                        patch=patch)

    return run
