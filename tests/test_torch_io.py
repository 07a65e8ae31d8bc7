"""The port's copies of the synthetic renderer and the trajectory metrics
give the reference's results exactly: the same scene, trajectory and
uint8 images, and the same sim3 alignment and ATE (float64 numpy in
both)."""

import numpy as np

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
