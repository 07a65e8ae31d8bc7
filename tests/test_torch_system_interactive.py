"""The port's System on the interactive path (``chunked=False``): each frame
through ``MonoTracker.track`` as it arrives.

- ``tests/test_system.py``'s export contract (line mode, the feature-level
  arc with projected boxes and their edges as segments, 8 box and 16
  object slots, CubeSLAM proposals on): keyframe
  trajectory rows of 8 fields, at least 2 keyframes, at least 2 objects
  with their keys, timing stats;
- ``current_pose`` returns (None, T): no timestamp on this path, as the
  reference's System returns it (a defect of both packages, pinned here
  and listed in ``ROADMAP.md`` Queue 3);
- FULL with ``chunked=False`` from raw images: the keyframe images are
  kept by slot and ``shutdown()`` runs the dense phase over the
  MonoTracker's keyframes, producing a cloud;
- reset and localization mode through the facade.
"""

import json

import numpy as np
import pytest

from eao_slam_torch.config import CapacityConfig, DemoFlag, tum3_config
from eao_slam_torch.geometry.camera import TUM3
from eao_slam_torch.io.synthetic import (make_arc_trajectory, make_room_scene, project_boxes,
                                         simulate_observations)
from eao_slam_torch.runtime.frame import frame_from_arrays
from eao_slam_torch.runtime.tracker import MonoTracker
from eao_slam_torch.system import System
from test_torch_full import arc, port_config

OK = 2


def small_cfg(flag=DemoFlag.EAO):
    return tum3_config(flag).replace(capacity=CapacityConfig(
        max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1536,
        max_boxes=8, max_objects=16))


def _box_edges(cfg, boxes):
    """The four edges of each valid box as line segments (line mode's
    input), padded to ``max_lines``."""
    L = cfg.capacity.max_lines
    bxs, _, _, bvalid = (np.asarray(x) for x in boxes)
    segs = []
    for x, y, w, h in bxs[bvalid]:
        segs += [(x, y, x + w, y), (x + w, y, x + w, y + h), (x + w, y + h, x, y + h),
                 (x, y + h, x, y)]
    segs = np.asarray(segs[:L], np.float32).reshape(-1, 4)
    lines = np.zeros((L, 4), np.float32)
    lines[:len(segs)] = segs
    return lines, np.arange(L) < len(segs)


def _feature_frames(cfg, n_frames=30):
    scene = make_room_scene(seed=3, n_landmarks=1200, n_objects=3)
    ts, gt = make_arc_trajectory(n_frames=n_frames, sweep_deg=30.0)
    rng = np.random.default_rng(7)
    frames = []
    for T in gt:
        o = simulate_observations(scene, TUM3, T, max_features=256, rng=rng, pixel_noise=0.4,
                                  bit_flips=6)
        boxes = project_boxes(scene, TUM3, T, cfg.capacity.max_boxes)
        lines = _box_edges(cfg, boxes) if cfg.flag.use_yaw_lines else (None, None)
        frames.append(frame_from_arrays(cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                        valid=o["valid"], boxes=boxes, lines=lines[0],
                                        line_valid=lines[1]))
    return ts, frames


def test_export_contract(tmp_path):
    """In line mode with ``use_cubeslam`` on, so the single-view cuboid
    proposals run on every tracked frame with boxes and segments (the box
    edges); a frame without segments gets none, as in the reference."""
    import dataclasses

    cfg = small_cfg(DemoFlag.LINE_IFOREST)
    cfg = cfg.replace(objects=dataclasses.replace(cfg.objects, use_cubeslam=True))
    sysm = System(cfg, chunked=False, device="cpu")
    assert isinstance(sysm.tracker, MonoTracker) and sysm.tracker.obj_updater is not None
    ts, frames = _feature_frames(cfg)
    poses = [sysm.track_frame(f, float(ts[i])) for i, f in enumerate(frames)]
    assert sum(T is not None for T in poses) >= 0.7 * len(frames)
    assert sysm.tracker.state == OK
    cub = sysm.tracker.last_cuboids
    assert cub is not None and cub.pos.shape == (cfg.capacity.max_boxes, 3)
    assert sysm.track_frame(frames[-1]._replace(lines=None, line_valid=None),
                            float(ts[-1]) + 0.03) is not None
    assert sysm.tracker.last_cuboids is None

    kf_path = tmp_path / "KeyFrameTrajectory.txt"
    n_kf = sysm.save_keyframe_trajectory_tum(str(kf_path))
    assert n_kf >= 2
    lines = kf_path.read_text().strip().splitlines()
    assert len(lines) == n_kf and len(lines[0].split()) == 8
    n_frames = len(sysm.frame_trajectory()[0])
    assert sysm.save_frame_trajectory_tum(str(tmp_path / "f.txt")) == n_frames

    obj_path = tmp_path / "objects.json"
    n_obj = sysm.save_objects_json(str(obj_path))
    assert n_obj >= 2
    objs = json.loads(obj_path.read_text())
    assert {"class", "center", "size", "yaw", "n_obs"} <= set(objs[0].keys())
    stats = sysm.timing_stats()
    assert stats == {} or stats["mean_s"] >= 0
    with pytest.raises(ValueError, match="chunked"):
        sysm.save_checkpoint(str(tmp_path / "x.ckpt"))


def test_current_pose_has_no_timestamp():
    """The reference's behaviour, pinned: (None, last pose)."""
    from eao_slam_tpu.config import CapacityConfig as JCap, tum3_config as jcfg
    from eao_slam_tpu.system import System as JSystem

    cfg = small_cfg(DemoFlag.NONE)
    sysm = System(cfg, chunked=False, device="cpu")
    ref = JSystem(jcfg().replace(capacity=JCap(max_keyframes=8, max_points=64, max_features=32,
                                               local_ba_points=32)), chunked=False)
    assert sysm.current_pose() is None and ref.current_pose() is None
    ts, frames = _feature_frames(cfg, n_frames=8)
    for i, f in enumerate(frames):
        T = sysm.track_frame(f._replace(boxes=None, box_class=None, box_score=None,
                                        box_valid=None), float(ts[i]))
    assert T is not None
    t, T_now = sysm.current_pose()
    assert t is None
    np.testing.assert_array_equal(T_now, T)
    ref.tracker.last_T = np.eye(3, 4, dtype=np.float32)
    assert ref.current_pose()[0] is None


def test_full_keeps_keyframe_images_and_shutdown_makes_a_cloud(tmp_path):
    ts, _, images, boxes = arc()
    n = 32
    sysm = System(port_config(), chunked=False, device="cpu")
    for k in range(n):
        sysm.track_monocular(images[k], float(ts[k]), boxes=boxes[k])
    tr = sysm.tracker
    assert tr.state == OK and len(sysm.frame_trajectory()[0]) >= 0.8 * n
    live = [s for s in tr.kf_slots if tr.kf_valid_host[s]]
    # every keyframe's image but the initializer's reference frame, which
    # became a keyframe at the next frame's call (as in the reference)
    assert len(live) >= 4 and set(live[1:]) <= set(sysm._kf_images)
    res = sysm.shutdown()
    assert res is not None and set(sysm._semidense_slots) == set(live) & set(sysm._kf_images)
    assert int(res.valid.sum()) > 0
    assert sysm.save_semidense_obj(str(tmp_path / "sd.obj")) > 0


def test_reset_and_localization_mode_through_the_facade():
    cfg = small_cfg(DemoFlag.NONE)
    sysm = System(cfg, chunked=False, device="cpu")
    ts, frames = _feature_frames(cfg, n_frames=30)
    frames = [f._replace(boxes=None, box_class=None, box_score=None, box_valid=None)
              for f in frames]
    for i in range(20):
        sysm.track_frame(frames[i], float(ts[i]))
    tr = sysm.tracker
    assert tr.state == OK
    sysm.activate_localization_mode()
    n_kf, n_pts = len(tr.kf_slots), int(tr.pt_valid_host.sum())
    tracked = sum(sysm.track_frame(frames[i], float(ts[i])) is not None for i in range(20, 30))
    assert tracked >= 9 and len(tr.kf_slots) == n_kf and int(tr.pt_valid_host.sum()) == n_pts
    sysm.deactivate_localization_mode()
    assert not tr.localization_only
    sysm.reset()
    assert tr.state == 0 and tr.kf_slots == [] and sysm.current_pose() is None
    for i in range(12):
        sysm.track_frame(frames[i], float(ts[i]))
    assert tr.state == OK and len(tr.kf_slots) >= 2
