"""Parity of the port's Sim3 algebra and Sim3 solver with the reference
package: ``geometry/sim3`` and ``solvers/sim3_solver``.

Tolerances:
- sim3 algebra: 1e-5 (float32 formulas evaluated in another order);
- the Sim3 RANSAC: torch cannot replay ``jax.random``, so the port is
  handed the reference's own draws (``hyp_idx``, drawn here with the
  reference's key and probabilities). S12 to 1e-4; inlier counts within
  2, as in ``test_torch_init2view.py``: a residual that sits on the chi2
  gate can fall on either side;
- the 5 + 10 Sim3 LM schedule: 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eao_slam_tpu.geometry import sim3 as jsim3, so3 as jso3
from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.solvers import sim3_solver as jss
from eao_slam_torch.geometry import sim3 as tsim3
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.solvers import sim3_solver as tss
from torch_parity import n, t


def _random_sim3(rng, k, scale_lo=0.7, scale_hi=1.4):
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.6, (k, 3)), jnp.float32)))
    tr = rng.normal(0, 0.5, (k, 3)).astype(np.float32)
    s = rng.uniform(scale_lo, scale_hi, k).astype(np.float32)
    return np.asarray(jsim3.make(jnp.asarray(R), jnp.asarray(tr), jnp.asarray(s)))


def test_sim3_parity():
    rng = np.random.default_rng(0)
    A, B = _random_sim3(rng, 32), _random_sim3(rng, 32)
    x = rng.normal(0, 2, (32, 3)).astype(np.float32)
    v = rng.normal(0, 0.3, (32, 7)).astype(np.float32)
    v[:4, 3:6] = 0.0                      # theta = 0 branch
    ja, jb = jnp.asarray(A), jnp.asarray(B)
    pairs = [
        (tsim3.apply(t(A), t(x)), jsim3.apply(ja, jnp.asarray(x))),
        (tsim3.compose(t(A), t(B)), jsim3.compose(ja, jb)),
        (tsim3.inverse(t(A)), jsim3.inverse(ja)),
        (tsim3.rot(t(A)), jsim3.rot(ja)),
        (tsim3.scale(t(A)), jsim3.scale(ja)),
        (tsim3.to_se3(t(A)), jsim3.to_se3(ja)),
        (tsim3.exp(t(v)), jsim3.exp(jnp.asarray(v))),
        (tsim3.retract(t(A), t(v)), jsim3.retract(ja, jnp.asarray(v))),
        (tsim3.log(t(A)), jsim3.log(ja)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    T = np.asarray(jsim3.to_se3(ja))
    np.testing.assert_allclose(n(tsim3.from_se3(t(T), 1.3)),
                               np.asarray(jsim3.from_se3(jnp.asarray(T), 1.3)), atol=1e-5)
    np.testing.assert_allclose(n(tsim3.make(tsim3.rot(t(A)), tsim3.trans(t(A)), tsim3.scale(t(A)))),
                               A * np.where(A[:, :1] < 0, -1, 1), atol=1e-5)
    assert n(tsim3.identity()).tolist() == np.asarray(jsim3.identity()).tolist()


def _reference_draws(key, valid, shape):
    p = jnp.asarray(valid, jnp.float32) / jnp.maximum(jnp.sum(valid), 1)
    return np.asarray(jax.random.choice(key, valid.shape[0], shape=shape, p=p))


def _sim3_pair(rng, n_pts=80, outlier_frac=0.3):
    X1 = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                   rng.uniform(4, 8, n_pts)], -1).astype(np.float32)
    S12 = _random_sim3(rng, 1, 0.8, 1.3)[0]
    X2 = np.array(jsim3.apply(jsim3.inverse(jnp.asarray(S12)), jnp.asarray(X1)))
    bad = rng.choice(n_pts, int(n_pts * outlier_frac), replace=False)
    X2[bad] += rng.uniform(0.5, 2.0, (len(bad), 3)).astype(np.float32)
    valid = rng.uniform(size=n_pts) > 0.05
    s2 = (1.2 ** (2 * rng.integers(0, 3, (2, n_pts)))).astype(np.float32)
    return X1, X2, valid, s2, S12


def test_horn_sim3_parity():
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 2, (6, 30, 3)).astype(np.float32)
    y = rng.uniform(-2, 2, (6, 30, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (6, 30)).astype(np.float32)
    want = np.asarray(jss.horn_sim3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
    got = n(tss.horn_sim3(t(x), t(y), t(w)))
    # the quaternion's sign is a convention of mat_to_quat; compare maps
    np.testing.assert_allclose(n(tsim3.apply(t(got)[:, None], t(x))),
                               np.asarray(jsim3.apply(jnp.asarray(want)[:, None], jnp.asarray(x))),
                               atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("seed", [5, 6])
def test_sim3_ransac_and_schedule_parity(seed):
    rng = np.random.default_rng(seed)
    X1, X2, valid, s2, S_true = _sim3_pair(rng)
    key = jax.random.PRNGKey(seed)
    args_j = (jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid),
              jnp.asarray(s2[0]), jnp.asarray(s2[1]))
    ref = jss.solve_sim3_ransac(JCAM, *args_j, key, n_hyp=512, min_inliers=8)
    idx = _reference_draws(key, valid, (512, 3))
    args_t = (t(X1), t(X2), t(valid), t(s2[0]), t(s2[1]))
    got = tss.solve_sim3_ransac(TCAM, *args_t, n_hyp=512, min_inliers=8, hyp_idx=t(idx))
    assert bool(got.success) == bool(ref.success) is True
    np.testing.assert_allclose(n(got.S12), np.asarray(ref.S12), atol=1e-4)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2

    # the 5 + 10 LM schedule from a perturbed seed, with octave weights
    S0 = np.asarray(jsim3.retract(jnp.asarray(S_true),
                                  jnp.asarray([0.05, -0.03, 0.04, 0.02, -0.02, 0.03, 0.05])))
    ref2 = jss.optimize_sim3_schedule(JCAM, jnp.asarray(S0), *args_j[:3],
                                      1.0 / args_j[3], 1.0 / args_j[4])
    got2 = tss.optimize_sim3_schedule(TCAM, t(S0), *args_t[:3], 1.0 / args_t[3], 1.0 / args_t[4])
    np.testing.assert_allclose(n(got2.S12), np.asarray(ref2.S12), atol=1e-4)
    assert abs(int(got2.n_inliers) - int(ref2.n_inliers)) <= 2
    assert bool(got2.success) == bool(ref2.success)
