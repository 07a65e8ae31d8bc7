"""The port's stage profiler against the reference's (``utils/profiling.py``):
the same samples give the same summary, report and log. The port's tracer
on its own: off, a stage is a shared no-op and records nothing; on, stages
nest (parent, self time, calls), counters go to the innermost stage, the
per-chunk records note torch's profiler, every stage is a ``span:`` range
of torch's profiler, synchronising-operation warnings are counted under
the innermost stage and kept from the user's warnings, and ``enable()`` is
idempotent and keeps what was recorded. Every System carries the tracer as
``profiler``."""

import time
import warnings

import pytest
import torch

from eao_slam_torch.utils import TRACER, StageProfiler
from eao_slam_torch.utils.profiling import SYNC_WARNING, merge_records
from eao_slam_tpu.utils.profiling import StageProfiler as JStageProfiler

SAMPLES = {"track": [0.0123, 0.0101, 0.0400], "extract": [0.002], "ba": [0.5, 0.25]}


def _filled(cls):
    p = cls()
    for name, xs in SAMPLES.items():
        for x in xs:
            p.add(name, x)
    return p


def test_summary_report_and_log_equal(tmp_path):
    ours, ref = _filled(StageProfiler), _filled(JStageProfiler)
    assert ours.summary() == ref.summary()
    assert ours.report() == ref.report()
    ours.write_log(str(tmp_path / "a.json"))
    ref.write_log(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    ours.reset()
    assert ours.summary() == {}


def test_stages_time_and_disable():
    p = StageProfiler()
    for _ in range(3):
        with p.stage("sleep"):
            time.sleep(0.01)
    s = p.summary()["sleep"]
    assert s["count"] == 3 and s["total_s"] >= 0.03 and s["max_s"] >= s["median_s"]
    off = StageProfiler(enabled=False)
    with off.stage("x"):
        pass
    assert off.summary() == {}


def test_an_off_stage_is_one_shared_no_op():
    off = StageProfiler(enabled=False)
    assert off.stage("a") is off.stage("b")
    with off.stage("a"):
        off.count("n")
        off.next_chunk()

    @off.staged("f")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert off.chunks == [] and off.summary() == {}


def test_nested_stages_parents_self_time_and_counters():
    p = StageProfiler()
    p.next_chunk()
    with p.stage("outer"):
        p.count("frames")
        with p.stage("inner"):
            time.sleep(0.02)
            p.count("frames", 2)
        with p.stage("inner"):
            pass
    p.count("loose")
    (rec,) = p.chunks
    outer, inner = rec["stages"]["outer"], rec["stages"]["inner"]
    assert outer["parent"] is None and inner["parent"] == "outer"
    assert outer["calls"] == 1 and inner["calls"] == 2
    assert inner["seconds"] >= 0.02 and inner["self_seconds"] == inner["seconds"]
    assert outer["self_seconds"] == pytest.approx(outer["seconds"] - inner["seconds"])
    assert outer["counts"] == {"frames": 1} and inner["counts"] == {"frames": 2}
    assert rec["counts"] == {"loose": 1} and rec["profiled"] is False
    p.next_chunk()
    with p.stage("outer"):
        pass
    total = merge_records(p.chunks)
    assert len(p.chunks) == 2 and total["stages"]["outer"]["calls"] == 2
    assert p.trace()["total"]["stages"]["inner"]["counts"] == {"frames": 2}


def test_stages_are_profiler_ranges_and_mark_their_chunk():
    from torch.profiler import ProfilerActivity, profile

    p = StageProfiler()
    p.next_chunk()
    with p.stage("quiet"):
        pass
    p.next_chunk()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with p.stage("chunk.track"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    names = {e.name for e in prof.events()}
    assert "span:chunk.track" in names
    assert [r["profiled"] for r in p.chunks] == [False, True]


def test_sync_warnings_are_counted_under_the_innermost_stage():
    p = StageProfiler()
    p.enable(count_syncs=True)
    p.next_chunk()
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with p.stage("outer"):
            warnings.warn(SYNC_WARNING + " (planted)")
            with p.stage("inner"):
                for _ in range(3):
                    warnings.warn(SYNC_WARNING + " (planted)")
                warnings.warn("the user's own warning")
    stages = p.chunks[0]["stages"]
    assert stages["inner"]["counts"] == {"host_syncs": 3}
    assert stages["outer"]["counts"] == {"host_syncs": 1}
    assert [str(w.message) for w in shown] == ["the user's own warning"]
    p.disable()


def test_syncs_are_not_counted_when_asked_not_to():
    p = StageProfiler()
    p.enable(count_syncs=False)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with p.stage("s"):
            warnings.warn(SYNC_WARNING)
    assert p.chunks[0]["stages"]["s"]["counts"] == {} and len(shown) == 1


def test_enable_is_idempotent_and_keeps_what_was_recorded():
    p = StageProfiler(enabled=False)
    p.enable()
    p.next_chunk()
    with p.stage("a"):
        p.count("frames")
    p.enable()
    p.enable()
    assert p.enabled and p.chunks[0]["stages"]["a"]["calls"] == 1
    p.disable()
    p.disable()
    assert not p.enabled and len(p.chunks) == 1
    p.enable()
    with p.stage("a"):
        pass
    assert p.chunks[0]["stages"]["a"]["calls"] == 2
    p.reset()
    assert p.chunks == [] and p.summary() == {}


def test_system_has_a_profiler():
    from eao_slam_torch.config import CapacityConfig, tum3_config
    from eao_slam_torch.system import System

    cfg = tum3_config().replace(capacity=CapacityConfig(
        max_keyframes=8, max_points=64, max_features=32, local_ba_points=32))
    for chunked in (True, False):
        sysm = System(cfg, chunked=chunked, device="cpu")
        assert sysm.profiler is TRACER and isinstance(TRACER, StageProfiler)
    assert not TRACER.enabled
