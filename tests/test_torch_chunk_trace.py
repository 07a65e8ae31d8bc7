"""The port's tracer inside its chunk program, on a tiny chunked EAO run on
the CPU (the 160x120 profile of tests/test_torch_current_pose.py, chunks
of 8 rendered frames with the objects' boxes): the run once with the
tracer off and once on, from the same seed.

- Off, nothing is recorded; on, the poses and keyframes are bit for bit
  those of the run with it off.
- Every stage the run reaches appears under its parent, once a chunk
  record for each chunk dispatched.
- ``frames`` counts the frames stepped, ``keyframes`` the growth of the
  keyframe allocator.
- The stages inside ``chunk.track`` leave it at most 10 % of self time.
- ``python -m eao_slam_torch.cli ... --trace PATH`` writes the stage tree
  and the counters to PATH and names it in the statistics.
"""

import json

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test worker)
from test_torch_current_pose import CAM, tiny_cfg

from eao_slam_torch import cli
from eao_slam_torch.config import CapacityConfig, DemoFlag
from eao_slam_torch.io.synthetic import (make_arc_trajectory, make_room_scene, project_boxes,
                                         render_image)
from eao_slam_torch.system import System
from eao_slam_torch.utils.profiling import TRACER, merge_records

CHUNK = 8
N_FRAMES = 29          # the bootstrap takes 5 frames of this arc, then 3 chunks

# stage -> its parent
PARENT = {
    "chunk.extract": None,
    "chunk.track": None,
    "frame.motion": "chunk.track",
    "frame.local_map": "chunk.track",
    "frame.objects": "chunk.track",
    "frame.keyframe": "chunk.track",
    "keyframe.triangulate": "frame.keyframe",
    "keyframe.fuse": "frame.keyframe",
    "chunk.window_ba": "chunk.track",
    "chunk.iforest": "chunk.track",
    "chunk.readback": "chunk.track",
    "chunk.record": None,
    "pass.merge_objects": None,
    "pass.maintain": None,
    "pass.close_loops": None,
    "pass.relocalize": None,
}


def eao_cfg():
    return tiny_cfg().replace(
        flag=DemoFlag.EAO,
        capacity=CapacityConfig(max_keyframes=32, max_points=1024, max_features=128,
                                local_ba_points=256, max_boxes=4, max_objects=8))


def _drive(traced: bool, imgs, ts, boxes) -> dict:
    TRACER.reset()
    if traced:
        TRACER.enable()
    try:
        sysm = System(eao_cfg(), chunk=CHUNK, device="cpu")
        kf_armed = None
        for i in range(len(ts)):
            sysm.track_monocular(imgs[i], float(ts[i]), boxes=boxes[i])
            if kf_armed is None and sysm.tracker.armed:
                kf_armed = sysm.tracker.kf_count_host
    finally:
        TRACER.disable()
    tr = sysm.tracker
    assert tr.n_maintenance == 0       # the allocator only grows
    return {"records": list(tr.records), "kf_armed": kf_armed, "kf_count": tr.kf_count_host,
            "kf_pose": tr.map.kf_pose.numpy().copy(), "chunks": TRACER.chunks,
            "samples": dict(TRACER.summary())}


@pytest.fixture(scope="module")
def runs():
    scene = make_room_scene(seed=5, n_landmarks=100, n_objects=2)
    ts, gt = make_arc_trajectory(n_frames=36, sweep_deg=50.0)
    ts, gt = ts[:N_FRAMES], gt[:N_FRAMES]
    imgs = np.stack([render_image(scene, CAM, T) for T in gt])
    boxes = [tuple(np.asarray(x) for x in project_boxes(scene, CAM, T, 4)) for T in gt]
    try:
        yield {"off": _drive(False, imgs, ts, boxes), "on": _drive(True, imgs, ts, boxes)}
    finally:
        TRACER.disable()
        TRACER.reset()


def test_tracer_off_records_nothing(runs):
    assert runs["off"]["chunks"] == [] and runs["off"]["samples"] == {}


def test_tracer_on_leaves_poses_and_keyframes_bit_identical(runs):
    off, on = runs["off"], runs["on"]
    assert len(on["records"]) == len(off["records"]) == N_FRAMES
    for (t0, T0, s0), (t1, T1, s1) in zip(off["records"], on["records"]):
        assert t0 == t1 and s0 == s1 and (T0 is None) == (T1 is None)
        if T0 is not None:
            np.testing.assert_array_equal(T0, T1)
    assert on["kf_count"] == off["kf_count"]
    np.testing.assert_array_equal(on["kf_pose"], off["kf_pose"])


@pytest.mark.parametrize("stage", sorted(PARENT))
def test_every_stage_appears_under_its_parent(runs, stage):
    chunks = runs["on"]["chunks"]
    assert len(chunks) == (N_FRAMES - 5) // CHUNK
    total = merge_records(chunks)["stages"]
    assert stage in total, sorted(total)
    assert total[stage]["parent"] == PARENT[stage]
    assert total[stage]["calls"] >= 1 and total[stage]["seconds"] > 0
    assert 0 <= total[stage]["self_seconds"] <= total[stage]["seconds"] + 1e-9
    every_chunk = ("chunk.extract", "chunk.track", "chunk.readback", "chunk.record",
                   "chunk.iforest") + tuple(p for p in PARENT if p.startswith("pass."))
    if stage in every_chunk:
        assert all(c["stages"][stage]["calls"] == 1 for c in chunks)


def test_frames_and_keyframes_are_counted(runs):
    on = runs["on"]
    total = merge_records(on["chunks"])
    counts = {}
    for s in total["stages"].values():
        for k, v in s["counts"].items():
            counts[k] = counts.get(k, 0) + v
    stepped = N_FRAMES - 5
    assert counts["frames"] == stepped
    assert counts["keyframes"] == on["kf_count"] - on["kf_armed"] > 0
    assert total["stages"]["frame.keyframe"]["calls"] == counts["keyframes"]
    assert total["stages"]["frame.motion"]["calls"] == stepped
    assert counts.get("host_syncs", 0) == 0          # counted on the card only


def test_children_of_track_cover_it(runs):
    track = merge_records(runs["on"]["chunks"])["stages"]["chunk.track"]
    assert track["self_seconds"] <= 0.10 * track["seconds"]


def test_cli_trace_writes_the_stage_tree(tmp_path, monkeypatch, capsys):
    def fake_demo(flag, n, device=None):
        TRACER.next_chunk()
        with TRACER.stage("chunk.track"):
            TRACER.count("frames", int(n))
        return {"keyframes": 0}

    monkeypatch.setattr(cli, "run_demo", fake_demo)
    path = str(tmp_path / "trace.json")
    try:
        assert cli.main(["demo", "EAO", "3", "--trace", path, "--device", "cpu"]) == 0
    finally:
        TRACER.reset()
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats == {"keyframes": 0, "trace_path": path} and not TRACER.enabled
    with open(path) as f:
        trace = json.load(f)
    assert len(trace["chunks"]) == 1
    track = trace["total"]["stages"]["chunk.track"]
    assert track["calls"] == 1 and track["counts"] == {"frames": 3} and track["parent"] is None
