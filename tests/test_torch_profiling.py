"""The port's stage profiler and device trace against the reference's
(``utils/profiling.py``): the same samples give the same summary, report
and log; ``sync`` passes any nesting of tensors through (and waits for
their CUDA devices on the card); ``device_trace`` writes a Chrome trace
through torch.profiler on the CPU, with ``annotate``'s spans in it; every
System carries a ``profiler``."""

import json
import time

import pytest
import torch

from eao_slam_torch.utils import StageProfiler, annotate, device_trace
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


def test_sync_passes_nested_tensors_through():
    tree = {"a": (torch.ones(2), [torch.zeros(1), 3]), "b": None}
    assert StageProfiler.sync(tree) is tree


def test_device_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        with annotate("eao_stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "eao_stage" for e in events)


def test_system_has_a_profiler():
    from eao_slam_torch.config import CapacityConfig, tum3_config
    from eao_slam_torch.system import System

    cfg = tum3_config().replace(capacity=CapacityConfig(
        max_keyframes=8, max_points=64, max_features=32, local_ba_points=32))
    for chunked in (True, False):
        assert isinstance(System(cfg, chunked=chunked, device="cpu").profiler, StageProfiler)


@pytest.mark.cuda
def test_sync_waits_for_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(2048, 2048, device="cuda")
    p = StageProfiler()
    with p.stage("matmul"):
        y = p.sync({"y": x @ x})
    assert torch.cuda.current_stream().query() and y["y"].shape == x.shape
