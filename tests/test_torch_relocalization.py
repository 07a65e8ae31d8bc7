"""Between-chunk relocalization in the port against the reference package
(``ChunkedTracker._maybe_relocalize``, Tracking::Relocalization at chunk
rate): the kidnap of ``tests/test_scan_tracker.py:98`` at test size.

The reference bootstraps on the feature-level test sequence; its carry
crosses to the port with ``convert.py``. Both are then kidnapped the same
way: LOST, a garbage last pose, and a real later frame's features as the
last frame. Both run the pass; the port's EPnP RANSAC is handed the
reference's draws. Tolerances: state exact; recovered pose 1e-3 (the EPnP
hypotheses come from a float32 eigensolver, see
``test_torch_pnp.py``); bound features within 2 of the
reference's (a residual on the chi2 gate can fall on either side). The
port then tracks the next chunk from the recovered pose.
"""

import numpy as np
import pytest
import torch

from eao_slam_torch.config import CapacityConfig as TCap, tum3_config as ttum3
from eao_slam_torch.convert import carry_from_numpy
from eao_slam_torch.runtime import frame as tframe, scan_tracker as tst
from eao_slam_torch.solvers import pnp as tpnp
from torch_parity import (
    feature_sequence,
    jax_carry_numpy,
    jax_feature_bootstrap,
    n,
    reference_draws_for,
)

CAP = dict(max_keyframes=64, max_points=4096, max_features=256, local_ba_points=1024)


@pytest.fixture(scope="module")
def bootstrapped():
    from eao_slam_tpu.config import CapacityConfig, tum3_config

    return jax_feature_bootstrap(tum3_config().replace(capacity=CapacityConfig(**CAP)))


def _kidnap_reference(jt, obs):
    import jax.numpy as jnp

    from eao_slam_tpu.runtime.frame import frame_from_arrays

    fr = frame_from_arrays(jt.cfg, kp=obs["kp"], desc=obs["desc"], octave=obs["octave"],
                           valid=obs["valid"])
    T_garbage = np.eye(3, 4, dtype=np.float32)
    T_garbage[:, 3] = 5.0
    jt.carry = jt.carry._replace(
        state=jnp.asarray(tst.LOST, jnp.int32), T_last=jnp.asarray(T_garbage),
        last_kp=fr.kp, last_desc=fr.desc, last_octave=fr.octave, last_valid=fr.valid,
        last_pt=jnp.full((CAP["max_features"],), -1, jnp.int32))
    jt.state_host = tst.LOST


def test_kidnapped_relocalization_parity(bootstrapped, monkeypatch):
    jt, i = bootstrapped
    ts, gt, obs = feature_sequence()
    k = i + 3
    _kidnap_reference(jt, obs[k])
    tcfg = ttum3().replace(capacity=TCap(**CAP))
    tt = tst.ChunkedTracker(tcfg, chunk=5, device="cpu")
    tt.carry = carry_from_numpy(jax_carry_numpy(jt.carry), "cpu")
    tt.kf_count_host, tt.pt_count_host = int(jt.kf_count_host), int(jt.pt_count_host)
    tt.state_host = tst.LOST
    monkeypatch.setattr(*reference_draws_for(tst, "pnp_ransac", tpnp.pnp_ransac, tcfg.seed,
                                             lambda n_hyp: (192, 8)))
    jt._maybe_relocalize()
    tt._maybe_relocalize()
    assert int(jt.carry.state) == tst.OK, "the reference did not relocalize"
    assert tt.carry.state == tt.state_host == tst.OK
    assert tt.n_relocalized == 1
    np.testing.assert_allclose(n(tt.carry.T_last), np.asarray(jt.carry.T_last), atol=1e-3)
    got, want = n(tt.carry.last_pt), np.asarray(jt.carry.last_pt)
    assert abs(int((got >= 0).sum()) - int((want >= 0).sum())) <= 2
    assert ((got == want) | (got < 0) | (want < 0)).all()
    assert not tt.carry.vel_ok

    # the next chunk tracks from the recovered pose
    frames = [tframe.frame_from_arrays(tcfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                       valid=o["valid"]) for o in obs[k:k + 5]]
    outs = tt.track_batch(tst.batch_from_frames(frames, ts[k:k + 5]))
    assert (outs.state == tst.OK).all()


def test_relocalization_skips_when_tracking(bootstrapped):
    """A chunk that ends OK leaves the carry alone (no readback at all)."""
    jt, _ = bootstrapped
    tt = tst.ChunkedTracker(ttum3().replace(capacity=TCap(**CAP)), chunk=5, device="cpu")
    tt.carry = carry_from_numpy(jax_carry_numpy(jt.carry), "cpu")
    tt.state_host = tst.OK
    before = tt.carry
    tt._maybe_relocalize()
    assert tt.carry is before and tt.n_relocalized == 0


def test_relocalization_from_blank_frame_stays_lost(bootstrapped):
    """A LOST chunk whose last frame has no features finds no candidate:
    the carry stays LOST, the generator is not drawn."""
    jt, _ = bootstrapped
    tt = tst.ChunkedTracker(ttum3().replace(capacity=TCap(**CAP)), chunk=5, device="cpu")
    carry = carry_from_numpy(jax_carry_numpy(jt.carry), "cpu")
    tt.carry = carry._replace(state=tst.LOST, last_valid=torch.zeros_like(carry.last_valid))
    tt.kf_count_host, tt.state_host = int(jt.kf_count_host), tst.LOST
    rng_state = tt.loop_rng.get_state().clone()
    tt._maybe_relocalize()
    assert tt.carry.state == tt.state_host == tst.LOST
    assert torch.equal(tt.loop_rng.get_state(), rng_state)
