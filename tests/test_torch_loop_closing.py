"""Loop closing in the port against the reference package
(``runtime/loop_closing.py`` through ``ChunkedTracker._maybe_close_loops``).

The fabricated drifted loop of ``tests/test_loop_chunked.py``: twelve
keyframes on a circle whose later poses drift in translation and scale,
and the last keyframe's duplicate of the first keyframe's landmarks. Both
packages run the between-chunk loop pass on the same carry (crossed with
``convert.py``); the port's Sim3 RANSAC is handed the reference's draws
and lands on the reference's seed Sim3 (1e-5, same inliers).

Two stages that follow are ill-conditioned on this map, in the reference
as much as in the port, so they cannot be held to a fixed digit:
- the 5 + 10 Sim3 LM: the loop points lie 3 m ahead within +-15 degrees,
  so scale trades against depth along the view axis; the reference moves
  its log-scale by up to 0.07 when one input coordinate moves by 1e-7. The
  port's LM runs (inlier count held to the reference's within 2), and the
  correction is handed the reference's Sim3;
- the global BA: one fixed keyframe leaves the monocular scale free, and
  the reference moves its poses by ~1.6e-2 when its points move by 1e-6.
  The port's poses after the whole pass are held to the reference's within
  twice that spread, measured here on the reference itself, plus 1e-3.
Everything else is held to the reference: closed loops, point bindings,
point validity and the motion model's point row exact; the poses and
points after the essential-graph correction and re-anchoring to 1e-3
(float32 solves whose normal equations are summed in another order). The
Sim3 LM is held to 1e-4 on a well-conditioned problem in
``test_torch_sim3.py``.

Also pinned here: the tf-idf document frequency of a replayed backlog
counts the later keyframes whose signatures are still zero, as the
reference does (ROADMAP.md Queue 3).
"""

import numpy as np
import pytest

from eao_slam_torch.config import CapacityConfig as TCap, tum3_config as ttum3
from eao_slam_torch.convert import (
    carry_from_numpy,
    loop_closer_from_numpy,
    map_state_to_numpy,
)
from eao_slam_torch.runtime import loop_closing as tlc, scan_tracker as tst
from eao_slam_torch.solvers import sim3_solver as tss
from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.runtime import loop_closing as jlc
from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker as JTracker
from torch_parity import jax_carry_numpy, n, reference_draws_for, t


@pytest.fixture(scope="module")
def loop_case():
    from tests.test_loop_chunked import _carry_from_tracker
    from tests.test_loop_closing import build_drifted_loop_tracker, small_cfg

    host, T_true, _ = build_drifted_loop_tracker(np.random.default_rng(12345))
    cfg = small_cfg()
    return host, T_true, _carry_from_tracker(host, cfg), cfg


def _arm(tracker, carry, host):
    n_kf = len(host.kf_slots)
    tracker.carry = carry
    tracker.kf_count_host = n_kf
    tracker.pt_count_host = int(host.pt_valid_host.sum())
    tracker.state_host = 2
    return n_kf


def _recorded(module, name, log):
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        log.append(out)
        return out

    return module, name, wrapped


def _after(cls, name, log):
    """Record the view's map after ``cls.name`` runs (and its input)."""
    fn = getattr(cls, name)

    def wrapped(self, tracker, *args, **kw):
        before = tracker.map
        fn(self, tracker, *args, **kw)
        log.append((before, tracker.map, args, kw))

    return cls, name, wrapped


def test_chunked_loop_pass_parity(loop_case, monkeypatch):
    import eao_slam_tpu.runtime.loop_closing as jlc_mod
    from eao_slam_tpu.runtime import local_mapping as jlm

    host, T_true, jcarry, jcfg = loop_case
    tcfg = ttum3().replace(capacity=TCap(max_keyframes=16, max_points=1024, max_features=128,
                                         local_ba_points=1024))
    monkeypatch.setattr(*reference_draws_for(tlc, "solve_sim3_ransac", tss.solve_sim3_ransac,
                                             tcfg.seed, lambda n_hyp: (n_hyp, 3)))
    seeds = {"ref": [], "port": []}
    monkeypatch.setattr(*_recorded(jlc_mod, "solve_sim3_ransac", seeds["ref"]))
    monkeypatch.setattr(*_recorded(tlc, "solve_sim3_ransac", seeds["port"]))
    refined = []
    monkeypatch.setattr(*_recorded(jlc_mod, "optimize_sim3_schedule", refined))

    def port_schedule(*args):
        own = tss.optimize_sim3_schedule(*args)
        ref = refined[len(port_lm)]
        port_lm.append(own)
        assert abs(int(own.n_inliers) - int(ref.n_inliers)) <= 2
        return tss.Sim3Result(S12=t(ref.S12), inliers=t(ref.inliers),
                              n_inliers=t(ref.n_inliers), success=t(ref.success))

    port_lm = []
    monkeypatch.setattr(tlc, "optimize_sim3_schedule", port_schedule)
    stages = {k: [] for k in ("ref_corr", "port_corr", "ref_ba")}
    monkeypatch.setattr(*_after(jlc.LoopCloser, "_correct_loop", stages["ref_corr"]))
    monkeypatch.setattr(*_after(tlc.LoopCloser, "_correct_loop", stages["port_corr"]))
    monkeypatch.setattr(*_after(jlc.LoopCloser, "_global_ba", stages["ref_ba"]))
    jt = JTracker(jcfg, chunk=4)
    tt = tst.ChunkedTracker(tcfg, chunk=4, device="cpu")
    n_kf = _arm(jt, jcarry, host)
    _arm(tt, carry_from_numpy(jax_carry_numpy(jcarry), "cpu"), host)
    for tr in (jt, tt):
        # signatures first, then the last keyframe again with the
        # consistency streak primed as two earlier sightings (this map has
        # one revisiting keyframe)
        tr._maybe_close_loops()
        assert tr.loop_closer.closed_loops == 0
        tr.loop_closer.consistent_streak = {(0, 1): 2}
        tr._loop_checked = n_kf - 1
        tr._maybe_close_loops()
    assert tt.loop_closer.closed_loops == jt.loop_closer.closed_loops == 1
    assert len(seeds["port"]) == len(seeds["ref"]) == len(port_lm) == len(refined) == 1
    np.testing.assert_allclose(n(seeds["port"][0].S12), np.asarray(seeds["ref"][0].S12), atol=1e-5)
    np.testing.assert_array_equal(n(seeds["port"][0].inliers), np.asarray(seeds["ref"][0].inliers))
    assert tt.loop_closer.last_loop_order == jt.loop_closer.last_loop_order
    # the essential-graph correction and re-anchoring
    (_, rc, _, _), (_, pc, _, _) = stages["ref_corr"][0], stages["port_corr"][0]
    np.testing.assert_allclose(n(pc.kf_pose), np.asarray(rc.kf_pose), atol=1e-3)
    np.testing.assert_allclose(n(pc.pt_pos), np.asarray(rc.pt_pos), atol=1e-3)

    # the whole pass, against the reference's own spread under its global BA
    before, after, args, _ = stages["ref_ba"][0]
    slots = list(range(n_kf))
    shaken = jlm.run_local_ba(JCAM, before._replace(pt_pos=before.pt_pos + 1e-6), slots,
                              list(args), jt.inner.scale2_np, 1024)
    spread = np.abs(shaken.poses - np.asarray(after.kf_pose)[slots]).max()
    a, b = map_state_to_numpy(tt.carry.m), jax_carry_numpy(jt.carry)["m"]
    for k in ("kf_pt_idx", "pt_valid", "kf_valid"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tol = 2 * spread + 1e-3
    np.testing.assert_allclose(a["kf_pose"], b["kf_pose"], atol=tol)
    np.testing.assert_allclose(n(tt.carry.T_last), np.asarray(jt.carry.T_last), atol=tol)
    np.testing.assert_array_equal(n(tt.carry.last_pt), np.asarray(jt.carry.last_pt))
    assert not tt.carry.vel_ok
    np.testing.assert_allclose(tt.loop_closer.signatures, jt.loop_closer.signatures, atol=1e-6)

    # the drift is gone at the loop's end, as in the reference's own test
    def end_err(poses):
        T, G = poses[n_kf - 1], T_true[n_kf - 1]
        return np.linalg.norm(-T[:3, :3].T @ T[:3, 3] + G[:3, :3].T @ G[:3, 3])
    assert end_err(a["kf_pose"]) < 0.2 * end_err(np.asarray(jcarry.m.kf_pose))


def test_loop_closer_state_crosses_with_convert(loop_case):
    host, _, _, jcfg = loop_case
    ref = jlc.LoopCloser(jcfg)
    ref.signatures[3] = 0.5
    ref.consistent_streak = {(np.int64(2), 4): 2}
    ref.last_loop_order, ref.closed_loops = 11, 1
    tcfg = ttum3().replace(capacity=TCap(max_keyframes=16, max_points=1024, max_features=128))
    fields = ("signatures", "consistent_streak", "last_loop_order", "closed_loops")
    got = loop_closer_from_numpy({k: getattr(ref, k) for k in fields}, tcfg)
    np.testing.assert_array_equal(got.signatures, ref.signatures)
    assert got.consistent_streak == {(2, 4): 2}
    assert all(type(s) is int for g in got.consistent_streak for s in g)
    assert (got.last_loop_order, got.closed_loops) == (11, 1)


class _View:
    """The part of the chunked tracker's loop view that detection reads."""

    def __init__(self, n_kf, valid, covis):
        self.kf_slots = list(range(n_kf))
        self.kf_valid_host = valid
        self.kfdb = None
        self.vocab = None
        self._covis = covis

    def covis_weights(self, slot):
        return self._covis[slot]


@pytest.mark.parametrize("future_valid", [True, False])
def test_detect_backlog_counts_future_keyframes_like_the_reference(future_valid):
    """Keyframes 0-9 have signatures; 10-13 are later keyframes of the same
    backlog, still zero. Word 0 is in all ten signed keyframes, so its idf
    is log(14 / 11) > 0 only while the four zero signatures count as
    documents (the reference's behaviour), and log(10 / 11) -> 0 when
    they do not. Keyframes 0 and 9 share word 0 only: keyframe 0 is a
    candidate for 9 in the first case and not in the second. The port
    matches the reference in both."""
    K = 16
    sig = np.zeros((K, tlc.N_WORDS), np.float32)
    sig[:10, 0] = 10.0
    sig[np.arange(10), 1 + np.arange(10)] = 1.0
    sig /= np.maximum(np.linalg.norm(sig, axis=1, keepdims=True), 1e-9)
    valid = np.arange(K) < (14 if future_valid else 10)
    covis = np.zeros((K, K), np.int64)
    out = {}
    for name, mod, cfg in (("ref", jlc, None), ("port", tlc, None)):
        if name == "ref":
            from eao_slam_tpu.config import CapacityConfig, tum3_config
        else:
            CapacityConfig, tum3_config = TCap, ttum3
        lc = mod.LoopCloser(tum3_config().replace(capacity=CapacityConfig(
            max_keyframes=K, max_points=256, max_features=32)))
        lc.signatures[:] = sig
        lc.consistent_streak = {(0,): 2}
        out[name] = (lc._detect(_View(14, valid, covis), 9, 9), lc.consistent_streak)
    assert out["port"] == out["ref"]
    assert out["port"][0] == ([0] if future_valid else [])
