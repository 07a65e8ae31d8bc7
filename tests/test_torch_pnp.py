"""Parity of the port's EPnP RANSAC (``solvers/pnp``, relocalization)
with the reference package's. Torch cannot replay ``jax.random``, so the
port is handed the reference's own draws (``hyp_idx``). Tolerances are
stated in each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eao_slam_tpu.geometry import so3 as jso3
from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.solvers import pnp as jpnp
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.solvers import pnp as tpnp
from torch_parity import n, t


def _reference_draws(key, valid, shape):
    p = jnp.asarray(valid, jnp.float32) / jnp.maximum(jnp.sum(valid), 1)
    return np.asarray(jax.random.choice(key, valid.shape[0], shape=shape, p=p))


def _pnp_problem(rng, n_pts=120, noise_px=0.5, outlier_frac=0.3):
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  rng.uniform(3, 8, n_pts)], -1).astype(np.float32)
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32)))
    tr = rng.normal(0, 0.3, 3).astype(np.float32)
    pc = X @ R.T + tr
    uv = np.stack([JCAM.fx * pc[:, 0] / pc[:, 2] + JCAM.cx,
                   JCAM.fy * pc[:, 1] / pc[:, 2] + JCAM.cy], -1).astype(np.float32)
    uv += rng.normal(0, noise_px, uv.shape).astype(np.float32)
    sel = rng.choice(n_pts, int(n_pts * outlier_frac), replace=False)
    uv[sel] += rng.uniform(30, 120, (len(sel), 2)).astype(np.float32)
    valid = rng.uniform(size=n_pts) > 0.1
    inv_s2 = (1.0 / 1.44 ** rng.integers(0, 4, n_pts)).astype(np.float32)
    return X, uv, valid, inv_s2, np.concatenate([R, tr[:, None]], 1)


def _pnp_count(T, X, uv, valid, inv_s2):
    """The reference's hypothesis score: inliers of each pose [B, 3, 4]."""
    from eao_slam_tpu.geometry import se3 as jse3
    from eao_slam_tpu.geometry.camera import project as jproject

    xc = jse3.apply(T[:, None], jnp.asarray(X)[None])
    r = jproject(JCAM, xc) - jnp.asarray(uv)[None]
    chi2 = jnp.sum(r * r, -1) * jnp.asarray(inv_s2)[None]
    return np.asarray(jnp.asarray(valid)[None] & (xc[..., 2] > 0.05) & (chi2 < jpnp.CHI2_PNP))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_parity(seed):
    """With the reference's draws the port elects the same hypothesis, and
    its LM polish from the reference's winner and consensus lands on the
    reference's pose to 1e-4. End to end the pose agrees to 1e-3 only: the
    EPnP null vector comes from a float32 12 x 12 eigensolver, which
    amplifies the summation order of M^T M to ~2e-4 in each hypothesis
    (median over the 192), and the 4 + 3 + 2 + 1 LM steps do not remove it."""
    from eao_slam_tpu.solvers.pose_lm import optimize_pose as jopt
    from eao_slam_torch.solvers.pose_lm import optimize_pose as topt

    rng = np.random.default_rng(seed)
    X, uv, valid, inv_s2, T_true = _pnp_problem(rng)
    key = jax.random.PRNGKey(seed)
    ref = jpnp.pnp_ransac(JCAM, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                          jnp.asarray(inv_s2), key)
    idx = _reference_draws(key, valid, (192, 8))
    got = tpnp.pnp_ransac(TCAM, t(X), t(uv), t(valid), t(inv_s2), hyp_idx=t(idx))
    assert bool(got.success) == bool(ref.success) is True
    np.testing.assert_allclose(n(got.T), np.asarray(ref.T), atol=1e-3)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2
    assert np.linalg.norm(n(got.T)[:, 3] - T_true[:, 3]) < 0.02

    T_ref = jax.vmap(lambda i: jpnp._epnp_once(JCAM, jnp.asarray(X)[i], jnp.asarray(uv)[i]))(
        jnp.asarray(idx))
    T_port = n(tpnp.epnp(TCAM, t(X)[t(idx).long()], t(uv)[t(idx).long()]))
    assert np.median(np.abs(T_port - np.asarray(T_ref)).max(axis=(1, 2))) < 1e-3
    inl_ref = _pnp_count(T_ref, X, uv, valid, inv_s2)
    inl_port = _pnp_count(jnp.asarray(T_port), X, uv, valid, inv_s2)
    best = int(inl_ref.sum(1).argmax())
    assert int(inl_port.sum(1).argmax()) == best
    assert abs(int(inl_port[best].sum()) - int(inl_ref[best].sum())) <= 2
    polish_ref = jopt(JCAM, T_ref[best], jnp.asarray(X), jnp.asarray(uv), jnp.asarray(inv_s2),
                      jnp.asarray(inl_ref[best]))
    polish = topt(TCAM, t(np.asarray(T_ref[best])), t(X), t(uv), t(inv_s2), t(inl_ref[best]))
    np.testing.assert_allclose(n(polish.T), np.asarray(polish_ref.T), atol=1e-4)
    np.testing.assert_allclose(np.asarray(polish_ref.T), np.asarray(ref.T), atol=1e-6)


def test_pnp_ransac_without_matches_fails():
    rng = np.random.default_rng(3)
    X, uv, _, inv_s2, _ = _pnp_problem(rng, n_pts=32)
    got = tpnp.pnp_ransac(TCAM, t(X), t(uv), torch.zeros(32, dtype=torch.bool), t(inv_s2),
                          generator=torch.Generator().manual_seed(0))
    assert not bool(got.success)
