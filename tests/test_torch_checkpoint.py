"""Chunked checkpoint and resume in the port (``runtime/checkpoint.py``,
``System.save_checkpoint`` / ``load_checkpoint``) against the reference
package's format and behaviour.

- A file the reference wrote loads into the port, and the next chunk from
  it equals the reference's next chunk from the same file: states,
  keyframe flags, inlier counts, allocators and point bindings exact;
  poses to 1e-4 (as ``test_torch_scan_tracker.py``'s one-chunk parity).
- Save and resume through the port's System mid-sequence gives the
  uninterrupted run's trajectory to 1e-5 (``tests/test_checkpoint.py:86``).
- Where the port deliberately diverges: consistency-streak groups with
  numpy integer members. The reference's ``json.dumps`` fails on them
  (ROADMAP.md Queue 3); the port writes Python ints.
"""

import numpy as np
import pytest

from eao_slam_torch.config import CapacityConfig as TCap, DemoFlag, tum3_config as ttum3
from eao_slam_torch.convert import map_state_to_numpy
from eao_slam_torch.runtime import checkpoint as tck, frame as tframe, scan_tracker as tst
from eao_slam_torch.system import System
from torch_parity import feature_sequence, jax_carry_numpy, jax_feature_bootstrap

CAP = dict(max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1024)


def _tcfg():
    return ttum3().replace(capacity=TCap(**CAP))


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    from eao_slam_tpu.config import CapacityConfig, tum3_config
    from eao_slam_tpu.runtime.checkpoint import save_chunked_checkpoint

    jt, i = jax_feature_bootstrap(tum3_config().replace(capacity=CapacityConfig(**CAP)))
    path = str(tmp_path_factory.mktemp("ckpt") / "reference.ckpt")
    save_chunked_checkpoint(path, jt)
    return path, jt, i


def test_reference_file_resumes_in_the_port(reference_file):
    from eao_slam_tpu.runtime.checkpoint import load_chunked_checkpoint as jload
    from eao_slam_tpu.runtime.frame import frame_from_arrays as jframe
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker as JTracker, batch_from_frames

    path, jt0, i = reference_file
    ts, _, obs = feature_sequence()
    jt = JTracker(jt0.cfg, chunk=5)
    jload(path, jt)
    jf = [jframe(jt.cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"], valid=o["valid"])
          for o in obs[i:i + 5]]
    oj = jt.track_batch(batch_from_frames(jf, ts[i:i + 5]))

    tt = tst.ChunkedTracker(_tcfg(), chunk=5, device="cpu")
    with pytest.warns(UserWarning, match="seeded afresh"):
        meta = tck.load_chunked_checkpoint(path, tt)
    assert meta["version"] == 2 and tt.armed
    assert tt.records == [(t, None if T is None else pytest.approx(T), s)
                          for t, T, s in jt0.records]
    np.testing.assert_array_equal(tt.loop_closer.signatures, jt0.loop_closer.signatures)
    tf = [tframe.frame_from_arrays(tt.cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                   valid=o["valid"]) for o in obs[i:i + 5]]
    ot = tt.track_batch(tst.batch_from_frames(tf, ts[i:i + 5]))

    for k in ("state", "is_kf", "n_inliers", "kf_count", "pt_count"):
        np.testing.assert_array_equal(getattr(ot, k), np.asarray(getattr(oj, k)), err_msg=k)
    np.testing.assert_allclose(ot.T, np.asarray(oj.T), atol=1e-4)
    a, b = map_state_to_numpy(tt.carry.m), jax_carry_numpy(jt.carry)["m"]
    for k in ("kf_pt_idx", "kf_valid", "pt_valid"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["kf_pose"], b["kf_pose"], atol=1e-4)
    assert tt._loop_checked == jt._loop_checked
    assert tt.last_kf_slots == [tuple(int(v) for v in x) for x in jt.last_kf_slots]


def _frames(cfg, lo, hi):
    ts, _, obs = feature_sequence()
    return [(tframe.frame_from_arrays(cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                      valid=o["valid"]), float(ts[j]))
            for j, o in zip(range(lo, hi), obs[lo:hi])]


def _drive(sysm, frames):
    for f, t in frames:
        sysm.track_frame(f, t)


def test_system_checkpoint_resume_equals_uninterrupted_run(tmp_path):
    """Save at a chunk boundary through the System facade, restore into a
    fresh System, finish: the same trajectory as the uninterrupted run."""
    cfg = _tcfg()
    frames = _frames(cfg, 0, 38)
    solo = System(cfg, chunk=5, device="cpu")
    n_boot = 0
    for f, t in frames:
        solo.track_frame(f, t)
        n_boot += not solo._armed
    solo.flush()
    ts_solo, T_solo = solo.tracker.frame_trajectory()
    assert solo.tracker.state == tst.OK

    half = n_boot + 1 + 2 * 5          # bootstrap, then two whole chunks
    first = System(cfg, chunk=5, device="cpu")
    _drive(first, frames[:half])
    assert not first._frame_buf
    path = str(tmp_path / "engine.ckpt")
    first.save_checkpoint(path)
    resumed = System(cfg, chunk=5, device="cpu")
    assert not resumed._armed
    meta = resumed.load_checkpoint(path)
    assert meta["version"] == 2 and resumed._armed
    np.testing.assert_array_equal(resumed.tracker.carry.T_last.numpy(),
                                  first.tracker.carry.T_last.numpy())
    assert resumed.tracker.loop_rng.get_state().equal(first.tracker.loop_rng.get_state())
    _drive(resumed, frames[half:])
    resumed.flush()
    ts_res, T_res = resumed.tracker.frame_trajectory()
    np.testing.assert_array_equal(ts_res, ts_solo)
    np.testing.assert_allclose(T_res, T_solo, atol=1e-5)


def test_save_casts_numpy_streak_members_where_the_reference_crashes(reference_file, tmp_path):
    """Deliberate divergence from the reference (ROADMAP.md Queue 3): a
    consistency group holding numpy integers makes the reference's save
    raise in ``json.dumps``; the port writes Python ints and reads them
    back."""
    from eao_slam_tpu.runtime.checkpoint import save_chunked_checkpoint as jsave

    _, jt, _ = reference_file
    jt.loop_closer.consistent_streak = {(np.int64(1), np.int64(2)): 2}
    with pytest.raises(TypeError, match="JSON serializable"):
        jsave(str(tmp_path / "ref.ckpt"), jt)
    jt.loop_closer.consistent_streak = {}

    sysm = System(_tcfg(), chunk=5, device="cpu")
    _drive(sysm, _frames(sysm.cfg, 0, 12))
    sysm.tracker.loop_closer.consistent_streak = {(np.int64(1), np.int64(2)): 2}
    path = str(tmp_path / "port.ckpt")
    sysm.save_checkpoint(path)
    back = System(_tcfg(), chunk=5, device="cpu")
    back.load_checkpoint(path)
    assert back.tracker.loop_closer.consistent_streak == {(1, 2): 2}


def test_mismatched_checkpoint_rejected(reference_file):
    path, _, _ = reference_file
    small = ttum3().replace(capacity=TCap(max_keyframes=32, max_points=2048, max_features=128))
    with pytest.raises(ValueError, match="shape"):
        tck.load_chunked_checkpoint(path, tst.ChunkedTracker(small, chunk=5, device="cpu"))
    other = tst.ChunkedTracker(_tcfg(), chunk=5, device="cpu")
    other.cfg = other.cfg.replace(flag=DemoFlag.EAO)
    with pytest.raises(ValueError, match="flag"):
        tck.load_chunked_checkpoint(path, other)
    with pytest.raises(RuntimeError, match="not armed"):
        tck.save_chunked_checkpoint(path + ".x", tst.ChunkedTracker(_tcfg(), device="cpu"))


def test_eao_checkpoint_round_trips_its_object_table(tmp_path):
    """An EAO tracker writes its object table as the reference's ``t_*``
    arrays (and the iForest generator's state under a key of its own) and
    reads both back; a geometry tracker writes no table."""
    from eao_slam_torch.objects.state import ObjectTable

    cfg = _tcfg().replace(flag=DemoFlag.EAO)
    sysm = System(cfg, chunk=5, device="cpu")
    _drive(sysm, _frames(cfg, 0, 12))
    sysm.flush()
    tab = sysm.tracker.carry.table
    tab = tab._replace(valid=tab.valid.clone(), n_obs=tab.n_obs.clone(),
                       center=tab.center.clone())
    tab.valid[[1, 4]] = True
    tab.n_obs[1] = 7
    tab.center[4] = 1.5
    sysm.tracker.carry = sysm.tracker.carry._replace(table=tab)
    sysm.tracker.carry.obj_rng.manual_seed(99)
    path = str(tmp_path / "eao.ckpt")
    sysm.save_checkpoint(path)
    data = np.load(path)
    assert {f"t_{f}" for f in ObjectTable._fields} <= set(data.files)
    assert "iforest_rng_state" in data.files
    for f in ObjectTable._fields:
        np.testing.assert_array_equal(data[f"t_{f}"], getattr(tab, f).numpy(), err_msg=f)
    back = System(cfg, chunk=5, device="cpu")
    back.load_checkpoint(path)
    for f in ObjectTable._fields:
        np.testing.assert_array_equal(getattr(back.tracker.obj_table, f).numpy(),
                                      getattr(tab, f).numpy(), err_msg=f)
    assert back.tracker.carry.obj_rng.get_state().equal(sysm.tracker.carry.obj_rng.get_state())

    geo = System(_tcfg(), chunk=5, device="cpu")
    _drive(geo, _frames(geo.cfg, 0, 12))
    geo.save_checkpoint(str(tmp_path / "geo.ckpt"))
    assert not any(k.startswith("t_") for k in np.load(str(tmp_path / "geo.ckpt")).files)
