"""The port's copies of the synthetic renderer, the trajectory metrics and
the TUM sequence contract give the reference's results exactly: the same
scene, trajectory and uint8 images, the same sim3 alignment and ATE
(float64 numpy in both), the same ground-truth lookups, and TUM and KITTI
trajectory files equal byte for byte. The GT-pose protocol runs through
the System facade as the reference's test drives it. The object-centre
measure of the EAO gates, which the reference has no counterpart of, is
checked on constructed maps."""

import numpy as np
import pytest

from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.io import synthetic as jsyn, trajectory as jtraj
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.io import synthetic as tsyn, trajectory as ttraj
from torch_parity import CPU  # noqa: F401  (one torch thread per test worker)


def test_bench_scene_and_frames_identical():
    kw = dict(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
    sj, st = jsyn.make_room_scene(**kw), tsyn.make_room_scene(**kw)
    tj, Tj = jsyn.make_arc_trajectory(n_frames=40, sweep_deg=60.0)
    tt, Tt = tsyn.make_arc_trajectory(n_frames=40, sweep_deg=60.0)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(Tt, Tj)
    for k in (0, 39):
        np.testing.assert_array_equal(tsyn.render_image(st, TCAM, Tt[k]),
                                      jsyn.render_image(sj, JCAM, Tj[k]))


def test_ate_and_umeyama_identical():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    y = 2.5 * x @ R.T + np.array([0.3, -1.0, 2.0]) + rng.normal(0, 0.01, (50, 3))
    for with_scale in (True, False):
        assert ttraj.ate_rmse(x, y, with_scale=with_scale) == jtraj.ate_rmse(x, y, with_scale=with_scale)
    for a, b in zip(ttraj.umeyama_alignment(x, y), jtraj.umeyama_alignment(x, y)):
        np.testing.assert_array_equal(a, b)


def test_orbit_closed_room_and_observations_identical():
    """The loop circuit's inputs: the closed room, the orbit and the
    feature-level observations drawn from one numpy generator."""
    kw = dict(seed=5, n_landmarks=300, n_objects=3, closed_room=True)
    sj, st = jsyn.make_room_scene(**kw), tsyn.make_room_scene(**kw)
    np.testing.assert_array_equal(st.landmarks, sj.landmarks)
    np.testing.assert_array_equal(st.descriptors, sj.descriptors)
    assert len(st.quads) == len(sj.quads)
    tj, Tj = jsyn.make_orbit_trajectory(n_frames=24, radius=2.2)
    tt, Tt = tsyn.make_orbit_trajectory(n_frames=24, radius=2.2)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(Tt, Tj)
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    for k in (0, 11, 23):
        oj = jsyn.simulate_observations(sj, JCAM, Tj[k], 128, rj)
        ot = tsyn.simulate_observations(st, TCAM, Tt[k], 128, rt)
        assert oj.keys() == ot.keys()
        for name in oj:
            np.testing.assert_array_equal(ot[name], oj[name], err_msg=name)
    np.testing.assert_array_equal(tsyn.render_image(st, TCAM, Tt[5]),
                                  jsyn.render_image(sj, JCAM, Tj[5]))


def _object_scene(sigma: float = 0.2):
    """Ground truth: the bench arc's keyframes every 5th frame and three
    objects 4-5 m ahead; the map: the same world under an arbitrary sim3
    (scale ``sigma``), each keyframe seeing one member point per object."""
    ts, gt = tsyn.make_arc_trajectory(n_frames=40, sweep_deg=60.0)
    kf = np.arange(0, 40, 5)
    rng = np.random.default_rng(3)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    t = np.array([0.4, -1.0, 2.0])
    scene_c = np.array([[-1.6, 0.7, 4.9], [0.0, 0.8, 4.4], [1.6, 1.0, 4.0]])
    # x_map = sigma R x_gt + t  =>  T_map = [R_gt R^T | sigma t_gt - R_gt R^T t]
    Rk = gt[kf, :, :3] @ R.T
    tk = sigma * gt[kf, :, 3] - Rk @ t
    m = dict(kf_valid=np.ones(len(kf), bool), kf_timestamp=ts[kf],
             kf_pose=np.concatenate([Rk, tk[..., None]], -1),
             kf_pt_idx=np.tile(np.arange(3), (len(kf), 1)),
             pt_valid=np.ones(3, bool), pt_object_id=np.arange(3))
    tab = dict(valid=np.ones(3, bool), bad=np.zeros(3, bool), cls=np.array([56, 62, 73]),
               center=sigma * scene_c @ R.T + t)
    return m, tab, ts, gt, scene_c, np.array([56, 62, 73]), sigma * R


@pytest.mark.parametrize("case", ["exact", "one object displaced", "class missing",
                                  "object unobserved"])
def test_object_centre_errors_read_objects_not_the_map_frame(case):
    """map_object_errors is blind to the map's frame and scale (an
    arbitrary sim3 of the world), reads an object's displacement in metres,
    and gives inf for a scene object with no observed object of its class.
    Tolerance 1e-9 m (float64 throughout)."""
    m, tab, ts, gt, scene_c, scene_cls, sR = _object_scene()
    want = [0.0, 0.0, 0.0]
    if case == "one object displaced":
        tab["center"][1] += sR @ np.array([0.3, 0.0, -0.4])    # 0.5 m in the world
        want[1] = 0.5
    elif case == "class missing":
        tab["bad"][2] = True
        want[2] = np.inf
    elif case == "object unobserved":
        m["kf_pt_idx"][:, 0] = -1
        want[0] = np.inf
    got = ttraj.map_object_errors(m, tab, ts, gt, scene_c, scene_cls)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_object_centre_errors_need_distinct_scene_classes():
    m, tab, ts, gt, scene_c, _, _ = _object_scene()
    with pytest.raises(ValueError):
        ttraj.map_object_errors(m, tab, ts, gt, scene_c, np.array([56, 56, 73]))


def _random_poses(n: int, seed: int = 0) -> np.ndarray:
    """n camera-from-world poses [n, 3, 4] float64: random rotations,
    including the identity and the three half turns about an axis (each
    quaternion pivot), and random translations."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)
    R[:4] = [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])]
    return np.concatenate([R, rng.normal(size=(n, 3, 1))], 2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_trajectory_files_byte_equal(tmp_path, dtype):
    """save_tum (float32 quaternions as the reference rounds them) and
    save_kitti write the reference's files byte for byte, with and without
    a validity mask; load_kitti_poses reads them back as the reference
    does."""
    T = _random_poses(400).astype(dtype)
    ts = 100.0 + np.arange(len(T)) / 30.0
    valid = np.random.default_rng(1).random(len(T)) < 0.9
    for kw in ({}, {"valid": valid}):
        paths = [str(tmp_path / f"{tag}.txt") for tag in ("ref", "port")]
        assert jtraj.save_tum(paths[0], ts, T, **kw) == ttraj.save_tum(paths[1], ts, T, **kw)
        assert open(paths[0]).read() == open(paths[1]).read()
        paths = [str(tmp_path / f"{tag}.kitti") for tag in ("ref", "port")]
        assert jtraj.save_kitti(paths[0], T, **kw) == ttraj.save_kitti(paths[1], T, **kw)
        assert open(paths[0]).read() == open(paths[1]).read()
        np.testing.assert_array_equal(ttraj.load_kitti_poses(paths[1]),
                                      jtraj.load_kitti_poses(paths[0]))
    assert ttraj.save_tum(str(tmp_path / "empty.txt"), [], np.zeros((0, 3, 4))) == 0
    assert ttraj.save_kitti(str(tmp_path / "empty.kitti"), np.zeros((0, 3, 4))) == 0
    assert open(tmp_path / "empty.kitti").read() == ""
    assert ttraj.load_kitti_poses(str(tmp_path / "empty.kitti")).shape == (0, 3, 4)


@pytest.mark.parametrize("pivot", ["w", "x", "y", "z"])
def test_tum_quaternion_follows_so3(pivot):
    """save_tum's numpy quaternion (rounded as the reference's files are)
    and the port's so3.mat_to_quat give the same unit quaternion, w >= 0,
    on random rotations whose largest pivot is ``pivot``: every component
    within 5e-7, four float32 ulps of 1.0 (the float32 rounding of the
    matrix and of the square roots differs between the two; measured: one
    ulp)."""
    import torch

    from eao_slam_torch.geometry.so3 import mat_to_quat

    R = _random_poses(2000)[:, :, :3]
    tr = np.einsum("nii->n", R)
    d = np.einsum("nii->ni", R)
    pivots = np.stack([tr, d[:, 0] - d[:, 1] - d[:, 2], -d[:, 0] + d[:, 1] - d[:, 2],
                       -d[:, 0] - d[:, 1] + d[:, 2]], 1)
    R = R[np.argmax(pivots, 1) == "wxyz".index(pivot)]
    assert len(R) >= 100
    got = np.stack([ttraj._tum_quaternion(r) for r in R])
    want = mat_to_quat(torch.as_tensor(R, dtype=torch.float32)).numpy()
    assert (got[:, 0] >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


def test_associate_by_time():
    rng = np.random.default_rng(2)
    a = np.sort(rng.uniform(0, 10, 200))
    b = np.sort(rng.uniform(0, 10, 150))
    for tol in (0.05, 0.01):
        got = ttraj.associate_by_time(a, b, tol)
        np.testing.assert_array_equal(got, jtraj.associate_by_time(a, b, tol))
        assert got.shape[1] == 2 and len(got) > 0
    assert ttraj.associate_by_time(a, b + 100.0).shape == (0, 2)


class TestGroundtruthProtocol:
    """The reference's GT-pose protocol tests (tests/test_io.py) on the
    port: the whole ground-truth file loads once, each frame looks up its
    pose by nearest timestamp, and System.set_groundtruth feeds the
    initializer frame's pose to the ground alignment."""

    def _write_gt(self, path, n=20):
        rows = [f"{100.0 + 0.1 * i:.4f} {0.01 * i:.4f} 0.0 {0.02 * i:.4f} 0 0 0 1\n"
                for i in range(n)]
        with open(path, "w") as f:
            f.write("# ground truth\n")
            f.writelines(rows)

    def test_per_frame_lookup(self, tmp_path):
        from eao_slam_tpu.io import tum as jtum
        from eao_slam_torch.io import tum as ttum

        p = str(tmp_path / "groundtruth.txt")
        self._write_gt(p)
        gt, gj = ttum.load_groundtruth(p), jtum.load_groundtruth(p)
        assert len(gt.timestamps) == 20
        for a, b in zip(gt, gj):
            np.testing.assert_array_equal(a, b)
        T = ttum.lookup_pose_matrix(gt, 100.5)
        assert T is not None and abs(T[0, 3] - 0.05) < 1e-6
        T = ttum.lookup_pose_matrix(gt, 100.52, tol=0.05)
        assert T is not None and abs(T[0, 3] - 0.05) < 1e-6
        assert ttum.lookup_pose_matrix(gt, 50.0, tol=0.05) is None
        for ts in (100.0, 100.52, 101.87, 103.0):
            np.testing.assert_array_equal(ttum.lookup_pose_matrix(gt, ts),
                                          jtum.lookup_pose_matrix(gj, ts))
        q = np.array([np.cos(0.3), 0.1, np.sin(0.3), -0.2])
        np.testing.assert_array_equal(ttum.pose_from_tq([1.0, 2.0, 3.0], q),
                                      jtum.pose_from_tq([1.0, 2.0, 3.0], q))
        lst = tmp_path / "rgb.txt"
        lst.write_text("# list\n100.0 rgb/100.png\n\n100.1 rgb/101.png\n")
        for a, b in zip(ttum.load_image_list(str(lst)), jtum.load_image_list(str(lst))):
            np.testing.assert_array_equal(a, b)

    def test_system_consumes_gt_for_alignment(self, tmp_path):
        """System.set_groundtruth + track_frame: only the initializer
        frame's pose is consumed; frames without a GT entry track on; the
        initial map lands in the ground frame."""
        from eao_slam_torch.config import CapacityConfig, tum3_config
        from eao_slam_torch.io.tum import GroundTruth
        from eao_slam_torch.runtime.frame import frame_from_arrays
        from eao_slam_torch.system import System

        cfg = tum3_config().replace(capacity=CapacityConfig(
            max_keyframes=32, max_points=2048, max_features=256, local_ba_points=512))
        scene = tsyn.make_room_scene(seed=5, n_landmarks=1000, n_objects=2)
        ts, gt_poses = tsyn.make_arc_trajectory(n_frames=14, sweep_deg=10.0)
        p = str(tmp_path / "groundtruth.txt")
        ttraj.save_tum(p, ts[:7], gt_poses[:7])     # ground truth for the first half only

        sysm = System(cfg, device="cpu")
        with pytest.raises(TypeError):
            sysm.set_groundtruth(42)
        sysm.set_groundtruth(p)
        assert isinstance(sysm._groundtruth, GroundTruth)
        rng = np.random.default_rng(7)
        for i in range(14):
            obs = tsyn.simulate_observations(scene, TCAM, gt_poses[i], max_features=256, rng=rng)
            obs.pop("lm_idx", None)
            sysm.track_frame(frame_from_arrays(cfg, device="cpu", **obs), float(ts[i]))
        sysm.flush()
        assert sysm.tracker.state == 2
        est_ts, _ = sysm.tracker.frame_trajectory()
        assert len(est_ts) >= 8
        inner = sysm.tracker.inner
        assert inner.init_gt is not None
        kts, kT = sysm.keyframe_trajectory()
        i0 = int(np.argmin(np.abs(ts - kts[0])))
        np.testing.assert_allclose(kT[0], gt_poses[i0], atol=1e-4)
