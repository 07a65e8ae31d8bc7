"""The port's copies of the synthetic renderer and the trajectory metrics
give the reference's results exactly: the same scene, trajectory and
uint8 images, and the same sim3 alignment and ATE (float64 numpy in
both). The object-centre measure of the EAO gates, which the reference
has no counterpart of, is checked on constructed maps."""

import numpy as np
import pytest

from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.io import synthetic as jsyn, trajectory as jtraj
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.io import synthetic as tsyn, trajectory as ttraj


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
