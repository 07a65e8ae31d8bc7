"""Ground alignment (src/Tracking.cc:1018-1045) in the port's MonoTracker:
given the initializer frame's ground-truth pose G = T_wc, the initial map
is rotated into the gravity-aligned ground frame.

- ``_align_world_to_ground`` on the same map (the reference's, converted)
  with the same G as the reference's: keyframe poses, point positions and
  point normals equal to 1e-5, over every slot;
- the reference's tilted-camera fixture (tests/test_ground_alignment.py,
  fed only until two-view initialization succeeds, since the port's
  MonoTracker is the bootstrap half): the first keyframe's pose equals the
  initializer frame's ground-truth T_cw to 1e-4 and the world's down axis
  is the ground's, by the reference test's own assertions.
"""

import numpy as np

from eao_slam_torch.config import CapacityConfig, DemoFlag, tum3_config
from eao_slam_torch.convert import map_state_from_numpy, map_state_to_numpy
from eao_slam_torch.runtime.frame import frame_from_arrays
from eao_slam_torch.runtime.tracker import OK, MonoTracker
from torch_parity import CPU

CAP = dict(max_keyframes=32, max_points=4096, max_features=256, local_ba_points=1024)


def _tilt(deg_roll, deg_pitch):
    """The reference fixture's world-frame tilt of the camera poses."""
    a, b = np.deg2rad(deg_roll), np.deg2rad(deg_pitch)
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    return Rx @ Ry


def _inverse(T):
    R = T[:3, :3].T
    return np.concatenate([R, (-R @ T[:3, 3])[:, None]], 1)


def test_align_world_to_ground_matches_the_reference():
    from eao_slam_tpu.config import CapacityConfig as JCap, tum3_config as jcfg
    from eao_slam_tpu.runtime.map_state import MapState as JMap, empty_map_state
    from eao_slam_tpu.runtime.tracker import MonoTracker as JTracker

    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    m = {k: np.array(v) for k, v in empty_map_state(JCap(**CAP))._asdict().items()}
    K, P = m["kf_pose"].shape[0], m["pt_pos"].shape[0]
    q = np.linalg.qr(rng.normal(size=(K, 3, 3)))[0]
    m["kf_pose"][:] = np.concatenate([q, rng.normal(size=(K, 3, 1))], 2)
    m["kf_valid"][:5] = True
    m["pt_pos"][:] = rng.normal(size=(P, 3)) * 3
    nrm = rng.normal(size=(P, 3))
    m["pt_normal"][:] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    m["pt_valid"][:300] = True
    G = np.concatenate([_tilt(18.0, -12.0) @ _tilt(0.0, 40.0), [[0.3], [-1.2], [2.0]]], 1)

    jt = JTracker(jcfg().replace(capacity=JCap(**CAP)))
    jt.map = JMap(**{k: jnp.asarray(v) for k, v in m.items()})
    jt._align_world_to_ground(G)
    tt = MonoTracker(tum3_config().replace(capacity=CapacityConfig(**CAP)), CPU)
    tt.map = map_state_from_numpy(m, CPU)
    tt._align_world_to_ground(G)
    got = map_state_to_numpy(tt.map)
    for f in ("kf_pose", "pt_pos", "pt_normal"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jt.map, f)), atol=1e-5, err_msg=f)
    for f in ("kf_valid", "pt_valid", "kf_pt_idx"):
        np.testing.assert_array_equal(got[f], m[f])


def test_tilted_camera_map_lands_in_ground_frame():
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import (
        make_arc_trajectory, make_room_scene, simulate_observations)

    cfg = tum3_config(DemoFlag.NONE).replace(capacity=CapacityConfig(**CAP))
    scene = make_room_scene(seed=3, n_landmarks=1500, n_objects=0)
    ts, gt = make_arc_trajectory(n_frames=16, sweep_deg=15.0)
    Q = _tilt(18.0, -12.0)
    gt_tilted = [np.concatenate([T[:3, :3] @ Q.T, T[:3, 3:4]], axis=1) for T in gt]
    rng = np.random.default_rng(7)

    tracker = MonoTracker(cfg, CPU)
    for i, T_cw in enumerate(gt_tilted):
        obs = simulate_observations(scene, TUM3, T_cw, max_features=256, rng=rng,
                                    pixel_noise=0.3, bit_flips=4)
        f = frame_from_arrays(cfg, kp=obs["kp"], desc=obs["desc"], octave=obs["octave"],
                              valid=obs["valid"], device=CPU)
        tracker.track(f, float(ts[i]), gt_pose=_inverse(np.asarray(T_cw, np.float32)))
        if tracker.state == OK:
            break
    assert tracker.state == OK
    assert len(tracker.kf_slots) >= 2

    kf0 = tracker.kf_slots[0]
    T0 = tracker.map.kf_pose[kf0].numpy()
    i0 = int(np.argmin(np.abs(ts - float(tracker.map.kf_timestamp[kf0]))))
    T0_gt = gt_tilted[i0]
    np.testing.assert_allclose(T0, T0_gt, atol=1e-4)
    down_slam = T0[:3, :3].T @ (T0_gt[:3, :3] @ np.array([0.0, 1.0, 0.0]))
    assert np.dot(down_slam, [0.0, 1.0, 0.0]) > 0.999
    # the tracker's pose of the second keyframe is in the same frame
    np.testing.assert_allclose(tracker.last_T, tracker.map.kf_pose[tracker.kf_slots[-1]].numpy())
