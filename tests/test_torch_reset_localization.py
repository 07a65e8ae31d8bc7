"""Reset, the early-loss auto-reset and localization mode in the port, on
both trackers (src/Tracking.cc:771-779, 2345-2393; src/System.cc:254-286).

- The interactive MonoTracker: ``tests/test_reset_localization.py``'s
  three scenarios (manual reset, early-loss auto-reset, a frozen map
  from a checkpoint tracked in localization mode), with its gates; the
  map checkpoint the reference writes loads here too.
- The chunked tracker: a chunk in localization mode inserts no keyframe
  and leaves the map's allocators where they were; reset returns it to
  the bootstrap; a checkpoint saved in localization mode (the port's and
  the reference's) loads in that mode and resumes it.
"""

import numpy as np
import pytest

from eao_slam_torch.config import CapacityConfig, tum3_config
from eao_slam_torch.geometry.camera import TUM3
from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, simulate_observations
from eao_slam_torch.runtime import checkpoint as tck, scan_tracker as tst
from eao_slam_torch.runtime.frame import frame_from_arrays
from eao_slam_torch.runtime.tracker import LOST, NO_IMAGES, OK, MonoTracker
from torch_parity import feature_sequence, jax_feature_bootstrap, n

CAP = dict(max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1024)


def cfg_small():
    return tum3_config().replace(capacity=CapacityConfig(**CAP))


def make_frames(cfg, n_frames=40, seed=3, sweep=35.0):
    """``tests/test_reset_localization.py``'s sequence."""
    scene = make_room_scene(seed=seed, n_landmarks=1200, n_objects=2)
    ts, gt = make_arc_trajectory(n_frames=n_frames, sweep_deg=sweep)
    rng = np.random.default_rng(7)
    obs = [simulate_observations(scene, TUM3, T, max_features=256, rng=rng, pixel_noise=0.4,
                                 bit_flips=6) for T in gt]
    return ts, gt, [frame_from_arrays(cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                      valid=o["valid"]) for o in obs]


def blank_frame(like):
    return like._replace(valid=like.valid & False)


def test_manual_reset_clears_map():
    cfg = cfg_small()
    ts, gt, frames = make_frames(cfg)
    t = MonoTracker(cfg, "cpu")
    for i in range(20):
        t.track(frames[i], float(ts[i]))
    assert t.state == OK and len(t.kf_slots) >= 2
    frame_id = t.frame_id
    t.reset()
    assert t.state == NO_IMAGES and len(t.kf_slots) == 0 and t.frame_id == frame_id
    assert not n(t.map.kf_valid).any() and not n(t.map.pt_valid).any()
    assert t.vocab is None and t.kfdb is None and t.records == []
    for i in range(20):
        t.track(frames[i], float(ts[i]))
    assert t.state == OK


def test_early_loss_auto_reset_recovers():
    cfg = cfg_small()
    ts, gt, frames = make_frames(cfg)
    t = MonoTracker(cfg, "cpu")
    i = 0
    while t.state != OK and i < 10:
        t.track(frames[i], float(ts[i]))
        i += 1
    assert t.state == OK and len(t.kf_slots) <= 5
    for _ in range(2):
        t.track(blank_frame(frames[i]), float(ts[i]))
        i += 1
    assert t.state == NO_IMAGES, "early loss must trigger a full reset"
    assert len(t.kf_slots) == 0
    tracked = 0
    while i < len(frames):
        tracked += t.track(frames[i], float(ts[i])) is not None
        i += 1
    assert t.state == OK
    assert tracked >= 15


def test_localization_mode_tracks_frozen_map(tmp_path):
    cfg = cfg_small()
    ts, gt, frames = make_frames(cfg)
    t1 = MonoTracker(cfg, "cpu")
    for i in range(25):
        t1.track(frames[i], float(ts[i]))
    assert t1.state == OK
    path = str(tmp_path / "map.ckpt")
    tck.save_checkpoint(path, t1)

    t2 = MonoTracker(cfg, "cpu")
    tck.load_checkpoint(path, t2)
    assert t2.state == LOST and t2.kf_slots == t1.kf_slots
    # signatures recomputed for every keyframe (t1 has them from its
    # local-mapping passes, not for the two bootstrap keyframes)
    seen = t1.loop_closer.signatures.any(1)
    assert seen.sum() >= len(t1.kf_slots) - 2
    assert t2.loop_closer.signatures[t1.kf_slots].any(1).all()
    np.testing.assert_allclose(t2.loop_closer.signatures[seen], t1.loop_closer.signatures[seen],
                               atol=1e-7)
    t2.set_localization_mode(True)
    n_kf = len(t2.kf_slots)
    n_pts = int(n(t2.map.pt_valid).sum())
    tracked = 0
    for i in range(25, 40):
        tracked += t2.track(frames[i], float(ts[i])) is not None
    assert t2.state == OK
    assert tracked >= 10, f"only {tracked}/15 tracked in localization mode"
    assert len(t2.kf_slots) == n_kf
    assert int(n(t2.map.pt_valid).sum()) == n_pts
    # a loss in localization mode never resets the frozen map
    t2.track(blank_frame(frames[39]), float(ts[39]))
    assert t2.state == LOST and len(t2.kf_slots) == n_kf


def test_reference_map_checkpoint_loads(tmp_path):
    """A MonoTracker map the reference saved resumes LOST in the port with
    the same map and host mirrors, and relocalizes on the next frame."""
    from eao_slam_tpu.config import CapacityConfig as JCap, tum3_config as jtum3
    from eao_slam_tpu.runtime.checkpoint import save_checkpoint
    from eao_slam_tpu.runtime.frame import frame_from_arrays as jframe
    from eao_slam_tpu.runtime.tracker import MonoTracker as JMono

    jcfg = jtum3().replace(capacity=JCap(**CAP))
    ts, _, frames = make_frames(cfg_small())
    jt = JMono(jcfg)
    for i in range(12):
        f = frames[i]
        jt.track(jframe(jcfg, kp=n(f.kp), desc=n(f.desc).view(np.uint32), octave=n(f.octave),
                        valid=n(f.valid)), float(ts[i]))
    assert jt.state == OK
    path = str(tmp_path / "reference.ckpt")
    save_checkpoint(path, jt)
    t = MonoTracker(cfg_small(), "cpu")
    meta = tck.load_checkpoint(path, t)
    assert meta["kf_slots"] == list(jt.kf_slots) and t.state == LOST
    np.testing.assert_array_equal(n(t.map.kf_desc).view(np.uint32), np.asarray(jt.map.kf_desc))
    np.testing.assert_array_equal(t.kf_pt_host, jt.kf_pt_host)
    np.testing.assert_array_equal(t.pt_valid_host, jt.pt_valid_host)
    assert t.track(frames[12], float(ts[12])) is not None and t.state == OK


def _chunked(cfg):
    """A port ChunkedTracker bootstrapped on ``feature_sequence`` (chunk 5)
    and the index of the first frame after the bootstrap."""
    ts, _, obs = feature_sequence()
    tt = tst.ChunkedTracker(cfg, chunk=5, device="cpu")
    i = 0
    while not tt.armed:
        tt.bootstrap(_frame(cfg, obs[i]), float(ts[i]))
        i += 1
    return tt, i


def _frame(cfg, o):
    return frame_from_arrays(cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                             valid=o["valid"])


def _chunk(tt, i):
    ts, _, obs = feature_sequence()
    return tt.track_batch(tst.batch_from_frames([_frame(tt.cfg, o) for o in obs[i:i + 5]],
                                                ts[i:i + 5]))


def test_chunked_localization_mode_and_reset():
    cfg = cfg_small()
    tt, i = _chunked(cfg)
    _chunk(tt, i)
    kf0, pt0 = tt.kf_count_host, tt.pt_count_host
    desc0 = n(tt.carry.m.pt_desc).copy()
    tt.set_localization_mode(True)
    assert not tt.carry.allow_kf and tt.inner.localization_only
    outs = _chunk(tt, i + 5)
    assert not outs.is_kf.any() and (outs.state == tst.OK).all()
    assert (tt.kf_count_host, tt.pt_count_host) == (kf0, pt0)
    np.testing.assert_array_equal(n(tt.carry.m.pt_desc), desc0)
    tt.set_localization_mode(False)
    assert tt.carry.allow_kf
    tt.reset()
    assert not tt.armed and tt.state == NO_IMAGES and tt.records == []
    assert tt.kf_slots == [] and tt.loop_closer.closed_loops == 0
    ts, _, obs = feature_sequence()
    j = 0
    while not tt.armed and j < 10:
        tt.bootstrap(_frame(cfg, obs[j]), float(ts[j]))
        j += 1
    assert tt.armed and tt.state == OK


def test_localization_checkpoints_round_trip(tmp_path):
    """The port's file saved in localization mode resumes in it and equals
    the uninterrupted run to 1e-5; the reference's file saved in that mode
    loads in it (``allow_kf`` False) and tracks without keyframes."""
    from eao_slam_tpu.config import CapacityConfig as JCap, tum3_config as jtum3
    from eao_slam_tpu.runtime.checkpoint import save_chunked_checkpoint as jsave

    cfg = cfg_small()
    ta, i = _chunked(cfg)
    _chunk(ta, i)
    ta.set_localization_mode(True)
    path = str(tmp_path / "port.ckpt")
    tck.save_chunked_checkpoint(path, ta)
    tb = tst.ChunkedTracker(cfg, chunk=5, device="cpu")
    meta = tck.load_chunked_checkpoint(path, tb)
    assert meta["localization_only"] and tb._localization_only and not tb.carry.allow_kf
    oa, ob = _chunk(ta, i + 5), _chunk(tb, i + 5)
    assert not ob.is_kf.any()
    np.testing.assert_allclose(ob.T, oa.T, atol=1e-5)
    np.testing.assert_array_equal(ob.state, oa.state)

    jt, k = jax_feature_bootstrap(jtum3().replace(capacity=JCap(**CAP)))
    jt.set_localization_mode(True)
    jpath = str(tmp_path / "reference.ckpt")
    jsave(jpath, jt)
    jt.set_localization_mode(False)
    tc = tst.ChunkedTracker(cfg, chunk=5, device="cpu")
    with pytest.warns(UserWarning, match="seeded afresh"):
        meta = tck.load_chunked_checkpoint(jpath, tc)
    assert meta["localization_only"] and not tc.carry.allow_kf
    outs = _chunk(tc, k)
    assert not outs.is_kf.any() and tc.kf_count_host == int(jt.kf_count_host)
