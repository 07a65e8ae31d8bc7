"""The readers of the program's own stages and counters
(``harness/program_trace.py`` and the metrics that use it) on the tracer
that a run of the tiny chunked cell on the CPU filled: loading a reader
turns the program's tracer on; a reader keeps the window's chunks and
leaves out the set-up's warm-up chunk and the chunk traced by torch's
profiler after the window; with no tracer in the program (an older
program) or nothing recorded, every reader returns None.

A fixture turns the tracer off and clears it after each test, so that
loading a reader leaks no tracing into other tests."""

from __future__ import annotations

import pytest

from harness import program_trace
from harness.spec import Spec

CHUNKED = "tiny_eao.chunked_tiny"
SEED = 3000000029
SECONDS = 4.0           # two chunks of 8 at the tiny traffic's 4 frames a second
STAGES = {"motion_ms_per_frame": "frame.motion",
          "local_map_ms_per_frame": "frame.local_map",
          "object_pass_ms_per_frame": "frame.objects",
          "keyframe_ms_per_kf": "frame.keyframe",
          "window_ba_ms_per_chunk": "chunk.window_ba"}
COUNTERS = ("host_syncs_per_frame.chunked", "motion_fallback_share")
NEW = tuple(STAGES) + COUNTERS


@pytest.fixture
def tracer():
    from eao_slam_torch.utils.profiling import TRACER

    TRACER.disable()
    TRACER.reset()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.reset()


def _profiled_chunk_after_the_window(drive):
    """As a traced run on the card does: one more chunk under torch's
    profiler once the window is done."""
    from torch.profiler import ProfilerActivity, profile

    window = drive.run_window

    def run_window(n):
        window(n)
        with profile(activities=[ProfilerActivity.CPU]):
            drive.more(drive.chunk)

    drive.run_window = run_window


def _sum(records, stage):
    return sum(r["stages"][stage]["seconds"] for r in records if stage in r["stages"])


def _count(records, name):
    return sum(s["counts"].get(name, 0) for r in records for s in r["stages"].values())


def test_readers_keep_the_window_chunks_alone(run_tiny, tracer):
    spec = Spec()
    readers = {name: spec.metric(name) for name in NEW}
    assert tracer.enabled                        # loading a reader switched it on
    res, _ = run_tiny(CHUNKED, SEED, SECONDS, patch=_profiled_chunk_after_the_window)
    frames = res["work"]["frames"]
    records = tracer.chunks
    # the warm-up chunk, the window's chunks, the profiled chunk
    assert frames == 16 and len(records) == 1 + frames // 8 + 1
    assert [r["profiled"] for r in records] == [False] * (len(records) - 1) + [True]
    window = records[1:-1]
    assert _count(window, "frames") == frames
    assert _count(window, "keyframes") == res["work"]["keyframes"]

    rec = {"mode": "chunked", "traffic": {"chunk": 8}, "device": {},
           "window": {"frames": frames, "seconds": 1.0}}
    got = {name: r.read(rec) for name, r in readers.items()}
    per_frame = 1e3 / frames
    assert got["motion_ms_per_frame"] == pytest.approx(_sum(window, "frame.motion") * per_frame)
    assert got["local_map_ms_per_frame"] == pytest.approx(
        _sum(window, "frame.local_map") * per_frame)
    assert got["object_pass_ms_per_frame"] == pytest.approx(
        _sum(window, "frame.objects") * per_frame)
    assert got["keyframe_ms_per_kf"] == pytest.approx(
        1e3 * _sum(window, "frame.keyframe") / _count(window, "keyframes"))
    assert got["window_ba_ms_per_chunk"] == pytest.approx(
        1e3 * _sum(window, "chunk.window_ba") / len(window))
    assert got["motion_fallback_share"] == pytest.approx(
        100.0 * _count(window, "motion_fallbacks") / frames)
    for name in STAGES:
        assert got[name] > 0, name
    # the host syncs are read on the card alone, under chunk.extract and
    # chunk.track: plant some in every record, inside and outside those
    assert got["host_syncs_per_frame.chunked"] is None
    for r, n in zip(records, (1000, 3, 4, 2000)):
        r["stages"]["frame.motion"]["counts"]["host_syncs"] = n
        r["stages"]["chunk.extract"]["counts"]["host_syncs"] = 1
        r["stages"]["chunk.record"]["counts"]["host_syncs"] = 500
    rec["device"] = {"sm_clock_hz": 1.98e9}
    assert readers["host_syncs_per_frame.chunked"].read(rec) == pytest.approx((3 + 4 + 2) / 16)


def test_readers_return_nothing_without_a_window_of_records(tracer):
    spec = Spec()
    rec = {"mode": "chunked", "traffic": {"chunk": 8}, "device": {"sm_clock_hz": 1.98e9},
           "window": {"frames": 16, "seconds": 1.0}}
    readers = [spec.metric(name) for name in NEW]
    assert all(r.read(rec) is None for r in readers)     # nothing recorded
    tracer.next_chunk()
    with tracer.stage("chunk.track"):
        tracer.count("frames", 8)
    assert all(r.read(rec) is None for r in readers)     # one chunk of the two
    assert all(r.read(dict(rec, mode="live")) is None for r in readers)


def test_a_program_without_the_tracer_reads_nothing(tracer, monkeypatch):
    from eao_slam_torch.utils import profiling

    monkeypatch.delattr(profiling, "TRACER")
    rec = {"mode": "chunked", "traffic": {"chunk": 8}, "device": {"sm_clock_hz": 1.98e9},
           "window": {"frames": 8, "seconds": 1.0}}
    spec = Spec()
    for name in NEW:
        assert spec.metric(name).read(rec) is None, name
    assert program_trace.window_records(rec) is None
    assert not tracer.enabled
