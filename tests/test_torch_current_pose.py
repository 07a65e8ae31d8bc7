"""System.current_pose and System.timing_stats on the port: the reference's
tests/test_current_pose.py (the 160x120 tiny profile, an arc of 8 + 2
chunks of 8 rendered frames) with the port's System on the CPU. Between
chunk dispatches the query returns the newest tracked record, or that
pose carried through the motion model once per buffered frame (to 1e-6 of
the same composition in float64), stamped with the newest buffered
timestamp; at a chunk boundary both forms agree exactly."""

import numpy as np

from eao_slam_torch.config import CapacityConfig, OrbConfig, TrackingConfig, tum3_config
from eao_slam_torch.geometry.camera import Camera
from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, render_image
from eao_slam_torch.system import System
from torch_parity import n

OK = 2
CAM = Camera(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120, fps=30.0)


def tiny_cfg():
    """The reference's tiny_profile_config, in the port's fields."""
    return tum3_config().replace(
        camera=CAM, orb=OrbConfig(n_levels=4),
        tracking=TrackingConfig(min_init_matches=40, min_tracked_for_ok=15,
                                min_matches_ref_kf=10, min_inliers_after_pose=8),
        capacity=CapacityConfig(max_keyframes=16, max_points=1024, max_features=128,
                                local_ba_points=256))


def _compose(A, B):
    return np.concatenate([A[:, :3] @ B[:, :3], (A[:, :3] @ B[:, 3:]) + A[:, 3:]], 1)


def test_current_pose_mid_buffer():
    scene = make_room_scene(seed=5, n_landmarks=100, n_objects=2)
    ts, gt = make_arc_trajectory(n_frames=8 + 2 * 8, sweep_deg=50.0)
    imgs = np.stack([render_image(scene, CAM, T) for T in gt])
    sysm = System(tiny_cfg(), chunk=8, device="cpu")

    assert sysm.current_pose() is None and sysm.timing_stats() == {}

    i = 0
    while not (sysm.tracker.armed and len(sysm._img_buf) == 4):
        sysm.track_monocular(imgs[i], float(ts[i]))
        i += 1
    assert sysm.tracker.state == OK

    t_rec, T_rec = sysm.current_pose(extrapolate=False)
    t_now, T_now = sysm.current_pose()
    assert t_now == float(ts[i - 1])
    assert t_now > t_rec
    assert T_now.shape == (3, 4) and np.isfinite(T_now).all()
    c = sysm.tracker.carry
    want = n(c.T_last).astype(np.float64)
    for _ in range(4):
        want = _compose(n(c.velocity).astype(np.float64), want)
    np.testing.assert_allclose(T_now, want, atol=1e-6)

    while len(sysm._img_buf) != 0:
        sysm.track_monocular(imgs[i], float(ts[i]))
        i += 1
    t_b, T_b = sysm.current_pose()
    t_b2, T_b2 = sysm.current_pose(extrapolate=False)
    assert t_b == t_b2
    np.testing.assert_array_equal(T_b, T_b2)

    stats = sysm.timing_stats()
    assert len(sysm.timings) == i
    assert stats["median_s"] <= stats["mean_s"] * len(sysm.timings)
    np.testing.assert_allclose(stats["mean_s"], np.mean(sysm.timings))
    np.testing.assert_allclose(stats["fps"], 1.0 / np.mean(sysm.timings))
