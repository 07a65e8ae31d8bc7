"""Each per-layer metric's reader on a recorded span and profile record,
and the trace reduction's arithmetic."""

from __future__ import annotations

import math

import pytest

from harness.spec import Spec
from harness.trace import name_gaps, union_seconds

TUM = {"camera": {"width": 640, "height": 480},
       "port": {"orb": {"n_levels": 8, "scale_factor": 1.2}}}


def record(profile=True):
    spans = {"extract_batch": [0.022, 0.020], "extract_track": [3.0, 2.5],
             "merge_objects": [0.05, 0.04], "maintain": [0.001, 0.001],
             "close_loops": [0.03, 0.0], "relocalize": [0.0, 0.0]}
    prof = {"wall_s": 5.0, "busy_s": 0.5, "launches": 192000,
            "ops": {"fast_nms_kernel(FastParams)": {"count": 1, "device_s": 1.83e-4},
                    "void at::native::elementwise_kernel<...>": {"count": 9000,
                                                                "device_s": 0.1}},
            "idle_gaps": []}
    return {"mode": "chunked", "config": TUM, "traffic": {"chunk": 32},
            "window": {"frames": 64, "seconds": 6.0}, "spans": spans,
            "profile": prof if profile else None, "traced_frames": 32,
            "device": {"sm_clock_hz": 1.98e9, "power_limit_w": 700.0}}


def read(name, rec):
    return Spec().metric(name).read(rec)


def test_span_readers_per_frame():
    rec = record()
    assert read("extract_ms_per_frame", rec) == pytest.approx(1e3 * 0.042 / 64)
    assert read("track_ms_per_frame", rec) == pytest.approx(1e3 * (5.5 - 0.042) / 64)
    assert read("passes_ms_per_frame", rec) == pytest.approx(1e3 * 0.122 / 64)


def test_profile_readers():
    rec = record()
    assert read("launches_per_frame.chunked", rec) == pytest.approx(6000.0)
    assert read("device_idle_pct.chunked", rec) == pytest.approx(90.0)


def test_fast_nms_roofline_counts_the_algorithm_at_the_cell_shapes():
    import importlib.util
    import os

    from harness.spec import BENCH_DIR

    spec = importlib.util.spec_from_file_location(
        "roofline", os.path.join(BENCH_DIR, "metrics", "fast_nms_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t, which = mod.bound_s(32, 480, 640, 8, 1.2, 1.98e9)
    px = 32 * sum(h * w for h, w in mod.level_sizes(480, 640, 8, 1.2))
    assert which == "operations"
    assert t == pytest.approx(px * 53 / (132 * 64 * 2 * 1.98e9))
    share = read("fast_nms_roofline", record())
    assert share == pytest.approx(100 * t / 1.83e-4)
    assert 0 < share < 100


def test_readers_return_nothing_when_nothing_was_read():
    rec = record(profile=False)
    rec["spans"] = {k: [] for k in rec["spans"]}
    for name in ("extract_ms_per_frame", "track_ms_per_frame", "passes_ms_per_frame",
                 "fast_nms_roofline", "launches_per_frame.chunked",
                 "device_idle_pct.chunked"):
        assert read(name, rec) is None, name


def test_union_and_gaps():
    busy, merged = union_seconds([(0, 10), (5, 20), (30, 40), (55, 60)])
    assert busy == pytest.approx(35e-6) and merged == [[0, 20], [30, 40], [55, 60]]
    spans = [("extract_track", 0, 60), ("extract_batch", 22, 28)]
    gaps = name_gaps(merged, spans)
    assert gaps[0][0] == "extract_track" and math.isclose(gaps[0][1], 15e-6)
    assert gaps[1][0] == "extract_batch" and math.isclose(gaps[1][1], 10e-6)
