"""The port's interactive MonoTracker against the reference package's.

Inputs: ``tests/test_tracking_e2e.py``'s sequence (the room of seed 3, a
40-degree arc of 50 frames, 256 simulated features a frame from
``default_rng(7)``). The reference tracks it; its state before chosen
frames crosses to the port (``convert.mono_tracker_from_numpy``), and both
packages take the same step from there:

- ``_track_frame`` on a frame that inserts no keyframe: pose to 1e-4,
  the feature -> point row exact;
- one keyframe's ``_local_mapping`` with BA replaced in both packages by
  a step that moves nothing (BA-free): observation table, point validity,
  descriptors, keyframe slots and BoW database exact, new points to 1e-4;
- ``_cull_keyframes``, ``_cull_points``, ``_need_new_keyframe``: exact;
- ``_relocalize`` with the reference's PnP hypotheses injected: pose to
  1e-3 (``test_torch_pnp.py``'s EPnP tolerance).

End to end, the port's MonoTracker meets ``test_tracking_e2e.py``'s own
gates on its sequence.
"""

import copy
from functools import lru_cache

import numpy as np
import pytest
import torch

from eao_slam_torch.convert import mono_tracker_from_numpy
from eao_slam_torch.runtime import tracker as ttr
from eao_slam_torch.runtime.frame import frame_from_arrays as t_frame
from eao_slam_torch.runtime.local_mapping import LocalBAResult
from eao_slam_torch.solvers import pnp as tpnp
from torch_parity import jax_mono_from_numpy, jax_mono_numpy, n, reference_draws_for

CAP = dict(max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1536)
SNAPSHOTS = (19, 20, 30)


def _cfgs(**mapping):
    from eao_slam_torch.config import CapacityConfig as TC, MappingConfig as TM, tum3_config as tt
    from eao_slam_tpu.config import CapacityConfig as JC, MappingConfig as JM, tum3_config as jt

    return (jt().replace(capacity=JC(**CAP), mapping=JM(**mapping)),
            tt().replace(capacity=TC(**CAP), mapping=TM(**mapping)))


@lru_cache(maxsize=None)
def sequence():
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import (make_arc_trajectory, make_room_scene,
                                             simulate_observations)

    scene = make_room_scene(seed=3, n_landmarks=1200, n_objects=3)
    ts, gt = make_arc_trajectory(n_frames=50, sweep_deg=40.0)
    rng = np.random.default_rng(7)
    obs = [simulate_observations(scene, TUM3, T, max_features=256, rng=rng, pixel_noise=0.4,
                                 bit_flips=6, dropout=0.05) for T in gt]
    return ts, gt, obs


def _frames(i):
    from eao_slam_tpu.runtime.frame import frame_from_arrays as j_frame

    jc, tc = _cfgs()
    o = sequence()[2][i]
    kw = dict(kp=o["kp"], desc=o["desc"], octave=o["octave"], valid=o["valid"])
    return j_frame(jc, **kw), t_frame(tc, **kw)


@lru_cache(maxsize=None)
def reference_run():
    """The reference's run: its numpy state before each snapshot frame, and
    each frame's returned pose and tracker after it."""
    from eao_slam_tpu.runtime.tracker import MonoTracker

    ts = sequence()[0]
    jt = MonoTracker(_cfgs()[0])
    snaps, after = {}, {}
    for i in range(max(SNAPSHOTS) + 1):
        if i in SNAPSHOTS:
            snaps[i] = jax_mono_numpy(jt)
        T = jt.track(_frames(i)[0], float(ts[i]))
        after[i] = (None if T is None else np.array(T), jax_mono_numpy(jt))
    return snaps, after


def _pair(i, **mapping):
    """Both packages' trackers holding the reference's state before frame i."""
    jc, tc = _cfgs(**mapping)
    d = copy.deepcopy(reference_run()[0][i])
    return jax_mono_from_numpy(d, jc), mono_tracker_from_numpy(d, ttr.MonoTracker(tc, "cpu"))


def test_converted_state_is_the_reference_state():
    d = reference_run()[0][19]
    assert d["vocab"] is not None and d["kfdb"]["present"].sum() == len(d["kf_slots"]) >= 5
    _, tt = _pair(19)
    np.testing.assert_array_equal(n(tt.map.kf_desc).view(np.uint32), d["map"]["kf_desc"])
    np.testing.assert_array_equal(tt.kfdb.vectors, d["kfdb"]["vectors"])
    assert tt.kf_slots == d["kf_slots"] and tt.state == ttr.OK


def test_track_frame_parity():
    i = 19
    ts = sequence()[0]
    T_want, d_after = reference_run()[1][i]
    assert len(d_after["kf_slots"]) == len(reference_run()[0][i]["kf_slots"])  # no keyframe
    _, tt = _pair(i)
    T = tt._track_frame(_frames(i)[1], float(ts[i]))
    np.testing.assert_allclose(T, T_want, atol=1e-4)
    np.testing.assert_array_equal(n(tt.last_pt), d_after["last_pt"])
    np.testing.assert_allclose(tt.velocity, d_after["velocity"], atol=1e-4)
    assert (tt.frames_since_kf, tt.peak_since_kf) == (d_after["frames_since_kf"],
                                                      d_after["peak_since_kf"])


def _no_ba(cam, state, window, fixed, scale2, max_points):
    """A BA that moves nothing: the window's poses as they are, no points,
    no dropped observations (either package's map types)."""
    W = len(window)
    poses = state.kf_pose[torch.as_tensor(window)] if isinstance(state.kf_pose, torch.Tensor) \
        else np.asarray(state.kf_pose)[window]
    points = (torch.zeros((1, 3)) if isinstance(poses, torch.Tensor)
              else np.zeros((1, 3), np.float32))
    return LocalBAResult(kf_slots=np.asarray(window, np.int64), poses=poses,
                         pt_slots=np.full((1,), -1, np.int64), points=points,
                         drop_obs=np.zeros((W, CAP["max_features"]), bool))


def test_local_mapping_parity_without_ba(monkeypatch):
    """Frame 20 becomes a keyframe in both packages from one state and one
    tracked pose: triangulation with two neighbours, fusion both ways, the
    duplicate merge, point culling, the descriptor refresh, keyframe
    culling and the loop closer's bookkeeping, with BA moving nothing."""
    import jax.numpy as jnp

    from eao_slam_tpu.runtime import tracker as jtr

    i = 20
    jt, tt = _pair(i)
    jf, tf = _frames(i)
    m = jt.map
    r = jtr.tk.track_motion_model(
        jt.cam, m.pt_pos, m.pt_valid, jnp.asarray(jtr.np_compose(jt.velocity, jt.last_T)),
        jt.last_frame.kp, jt.last_frame.desc, jt.last_frame.octave, jt.last_frame.angle,
        jt.last_frame.valid, jt.last_pt, jf.kp, jf.desc, jf.octave, jf.angle, jf.valid,
        jt.scale2)
    r2 = jtr.tk.track_local_map_step(jt.cam, m.pt_pos, m.pt_valid, m.pt_desc, m.pt_normal,
                                     m.pt_min_dist, m.pt_max_dist, r.T, r.cur_pt, jf.kp, jf.desc,
                                     jf.octave, jf.valid, jt.scale2)
    T, cur_pt = np.asarray(r2.T), np.asarray(r2.cur_pt)
    monkeypatch.setattr(jtr, "run_local_ba", _no_ba)
    monkeypatch.setattr(ttr, "run_local_ba", _no_ba)
    ts = float(sequence()[0][i])
    jt.frame_id = tt.frame_id = jt.frame_id + 1
    jt._insert_keyframe(jf, ts, T, cur_pt)
    tt._insert_keyframe(tf, ts, T, cur_pt)
    n_before = jt.n_points
    jt._local_mapping()
    tt._local_mapping()
    assert jt.n_points > n_before                       # points were triangulated
    want, got = jax_mono_numpy(jt), ttr_state(tt)
    assert got["kf_slots"] == want["kf_slots"] and got["n_points"] == want["n_points"]
    for k in ("kf_pt_host", "kf_valid_host", "pt_valid_host", "pt_first_kf_host"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("kf_pt_idx", "pt_valid", "pt_first_kf", "kf_valid", "pt_desc"):
        np.testing.assert_array_equal(got["map"][k], want["map"][k], err_msg=k)
    new = np.flatnonzero(want["pt_valid_host"] & (want["pt_first_kf_host"] == want["kf_slots"][-1]))
    assert len(new) > 0
    for k in ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist"):
        np.testing.assert_allclose(got["map"][k][new], want["map"][k][new], atol=1e-4, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["kfdb"]["present"], want["kfdb"]["present"])
    np.testing.assert_allclose(got["kfdb"]["vectors"], want["kfdb"]["vectors"], atol=1e-6)
    np.testing.assert_allclose(got["loop_closer"]["signatures"],
                               want["loop_closer"]["signatures"], atol=1e-6)


def ttr_state(tt) -> dict:
    from eao_slam_torch.convert import mono_tracker_to_numpy

    d = mono_tracker_to_numpy(tt)
    d["map"] = {k: (v.view(np.uint32) if k.endswith("desc") else v) for k, v in d["map"].items()}
    return d


@pytest.mark.parametrize("redundancy", [0.9, 0.3])
def test_cull_keyframes_and_points_exact(redundancy):
    """The default 90 % rule, and 30 % so that keyframes do go."""
    jt, tt = _pair(30, kf_cull_redundancy=redundancy)
    window = list(jt.kf_slots)
    jt._cull_keyframes(window)
    tt._cull_keyframes(window)
    jt._cull_points()
    tt._cull_points()
    want, got = jax_mono_numpy(jt), ttr_state(tt)
    if redundancy < 0.5:
        assert len(want["kf_slots"]) < len(window)
    assert got["kf_slots"] == want["kf_slots"]
    for k in ("kf_pt_host", "kf_valid_host", "pt_valid_host"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("kf_pt_idx", "kf_valid", "pt_valid"):
        np.testing.assert_array_equal(got["map"][k], want["map"][k], err_msg=k)
    np.testing.assert_array_equal(got["kfdb"]["present"], want["kfdb"]["present"])


def test_need_new_keyframe_exact():
    jt, tt = _pair(20)
    jf, tf = _frames(20)
    for since in (0, 5, 29, 30):
        for ref, peak in ((100, 120), (150, 90), (0, 0)):
            for appear in (False, True):
                for n_tr in (10, 16, 80, 107, 108, 200):
                    for tr in (jt, tt):
                        tr.frames_since_kf, tr.ref_kf_tracked, tr.peak_since_kf = since, ref, peak
                        tr._appear_new_object = appear
                    assert tt._need_new_keyframe(tf, n_tr) == jt._need_new_keyframe(jf, n_tr)


def test_relocalize_with_reference_hypotheses(monkeypatch):
    """LOST before frame 30, fed frame 30: candidates from the BoW database
    (same list in both), EPnP RANSAC on the reference's draws, local-map
    tracking."""
    import jax

    from eao_slam_torch.ops import bow as tb

    i = 30
    jt, tt = _pair(i)
    jf, tf = _frames(i)
    jt.state = tt.state = ttr.LOST
    assert tt._reloc_candidates(tf) == jt._reloc_candidates(jf)
    assert tt.kfdb is not None and tt._reloc_candidates(tf)
    seed = 99
    jt.rng_key = jax.random.PRNGKey(seed + 7)
    monkeypatch.setattr(*reference_draws_for(ttr, "pnp_ransac", tpnp.pnp_ransac, seed,
                                             lambda n_hyp: (192, 8)))
    ts = float(sequence()[0][i])
    T_want = jt._relocalize(jf, ts)
    T = tt._relocalize(tf, ts)
    assert T_want is not None and jt.state == ttr.OK, "the reference did not relocalize"
    assert tt.state == ttr.OK and tt.velocity is None
    np.testing.assert_allclose(T, T_want, atol=1e-3)
    got, want = n(tt.last_pt), np.asarray(jt.last_pt)
    assert abs(int((got >= 0).sum()) - int((want >= 0).sum())) <= 2
    assert tb.quantize(tt.vocab, tf.desc)[0].shape == (CAP["max_features"],)


def test_port_meets_the_e2e_gates():
    """``tests/test_tracking_e2e.py``'s gates on its own sequence: OK at
    the end, >= 70 % tracked, sim3 ATE < 2 cm; every observation of the
    first 30 frames' map refers to a valid point."""
    from eao_slam_torch.io.trajectory import associate_by_time, ate_rmse

    ts, gt, obs = sequence()
    _, tc = _cfgs()
    tr = ttr.MonoTracker(tc, "cpu")
    tracked = 0
    for i in range(len(obs)):
        tracked += tr.track(_frames(i)[1], float(ts[i])) is not None
        if i == 29:
            assert len(tr.kf_slots) >= 2 and tr.pt_valid_host.sum() > 100
            for s in tr.kf_slots:
                live = tr.kf_pt_host[s][tr.kf_pt_host[s] >= 0]
                assert tr.pt_valid_host[live].all()
            np.testing.assert_array_equal(n(tr.map.pt_valid), tr.pt_valid_host)
            np.testing.assert_array_equal(n(tr.map.kf_pt_idx), tr.kf_pt_host)
    assert tr.state == ttr.OK
    assert tracked >= int(0.7 * len(obs))
    est_ts, est_T = tr.frame_trajectory()
    pairs = associate_by_time(est_ts, ts)
    assert len(pairs) == len(est_ts)
    est_c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in est_T])
    gt_c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in gt[pairs[:, 1]]])
    assert ate_rmse(est_c, gt_c, with_scale=True) < 0.02
    assert tr.vocab is not None and tr.kfdb.present.sum() == len(tr.kf_slots)
