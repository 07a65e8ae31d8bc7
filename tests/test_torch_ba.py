"""Parity of the Schur-complement LM bundle adjustment with
eao_slam_tpu.solvers.ba.

Trouble spot named here: scatters with duplicate indices. The reference
assembles the normal equations with one-hot matmuls whose f32 operands are
split into two bf16 halves (about 16 mantissa bits kept); the port
scatters with ``index_add_`` and accumulates in float64, because GPU
atomics add in no fixed order. The blocks therefore agree to 1e-4 of
their largest entry, not bit for bit. After 5 + 10 LM iterations, poses
agree to 1e-3 (rotation entries; translation on a unit-depth scene),
points to 1e-3 of the scene depth, and the inlier sets exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from eao_slam_tpu.geometry import se3 as jse3
from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.solvers import ba as jba
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.solvers import ba as tba
from torch_parity import n, t


def _problem(seed: int, K: int = 5, P: int = 160):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1, 1, P), rng.uniform(3, 6, P)], 1)
    twists = np.zeros((K, 6))
    twists[:, 0] = -0.15 * np.arange(K)
    twists[:, 4] = 0.02 * np.arange(K)
    poses = np.asarray(jse3.exp(jnp.asarray(twists, jnp.float32)))
    kf_idx, pt_idx, uv = [], [], []
    for k in range(K):
        xc = X @ poses[k, :, :3].T + poses[k, :, 3]
        u = TCAM.fx * xc[:, 0] / xc[:, 2] + TCAM.cx
        v = TCAM.fy * xc[:, 1] / xc[:, 2] + TCAM.cy
        seen = rng.random(P) < 0.8
        for p in np.nonzero(seen)[0]:
            kf_idx.append(k)
            pt_idx.append(p)
            uv.append((u[p], v[p]))
    O = len(kf_idx)
    uv = np.asarray(uv) + rng.normal(0, 0.6, (O, 2))
    uv[rng.random(O) < 0.04] += rng.uniform(-25, 25, (1, 2))       # outliers
    noisy_twists = twists + np.concatenate([rng.normal(0, 0.01, (K, 3)),
                                            rng.normal(0, 0.004, (K, 3))], 1)
    noisy_twists[0] = twists[0]
    init_poses = np.asarray(jse3.exp(jnp.asarray(noisy_twists, jnp.float32)))
    init_pts = X + rng.normal(0, 0.03, X.shape)
    pt_valid = np.ones(P + 8, bool)
    pt_valid[P:] = False                        # padded point rows
    fields = dict(
        poses=init_poses.astype(np.float32),
        points=np.concatenate([init_pts, np.zeros((8, 3))]).astype(np.float32),
        kf_idx=np.asarray(kf_idx, np.int32),
        pt_idx=np.asarray(pt_idx, np.int32),
        uv=uv.astype(np.float32),
        inv_sigma2=(1.0 / 1.2 ** (2 * rng.integers(0, 3, O))).astype(np.float32),
        obs_valid=rng.random(O) < 0.97,
        cam_fixed=np.arange(K) < 1,
        cam_valid=np.ones(K, bool),
        pt_valid=pt_valid,
    )
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    tprob = tba.BAProblem(**{k: t(v) for k, v in fields.items()})
    return jprob, tprob


def test_normal_equation_blocks():
    jprob, tprob = _problem(0)
    G = jba._build_gather(jprob)
    J = jba._lm_system(JCAM, jprob, jprob.poses, jprob.points, G)
    T = tba._lm_system(TCAM, tprob, tprob.poses, tprob.points)
    for name, a, b in zip(("Hcc", "Hpp", "Wcp", "bc", "bp", "cost"), T, J):
        a, b = n(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("schedule", ["bundle_adjust", "local_ba"])
def test_bundle_adjust_parity(schedule):
    jprob, tprob = _problem(1)
    if schedule == "bundle_adjust":
        rj = jba.bundle_adjust(JCAM, jprob, iters=10)
        rt = tba.bundle_adjust(TCAM, tprob, iters=10)
    else:
        rj = jba.local_ba(JCAM, jprob)
        rt = tba.local_ba(TCAM, tprob)
    np.testing.assert_allclose(n(rt.poses), np.asarray(rj.poses), atol=1e-3)
    np.testing.assert_allclose(n(rt.points), np.asarray(rj.points), atol=1e-3 * 6.0)
    np.testing.assert_array_equal(n(rt.obs_inlier), np.asarray(rj.obs_inlier))
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    # the solve did something: the cost fell well below the initial one
    c0 = float(jba._cost_only(JCAM, jprob, jprob.poses, jprob.points))
    assert float(rt.cost) < 0.5 * c0
