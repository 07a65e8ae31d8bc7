"""Parity of eao_slam_torch.geometry with eao_slam_tpu.geometry.

Tolerance: float32 elementwise formulas evaluated in a different order
agree to a few ulp; 1e-5 absolute covers unit-scale rotations/points.
Triangulation goes through a batched 4x4 eigh in both packages, whose
LAPACK paths differ: points agree to 1e-4 relative."""

import jax.numpy as jnp
import numpy as np
import pytest

from eao_slam_tpu.geometry import camera as jcam, se3 as jse3, so3 as jso3
from eao_slam_tpu.geometry import triangulate as jtri
from eao_slam_torch.geometry import camera as tcam, se3 as tse3, so3 as tso3
from eao_slam_torch.geometry import triangulate as ttri
from torch_parity import n, t

ATOL = 1e-5


@pytest.fixture
def twists():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (64, 6)).astype(np.float32)
    xi[:4, 3:] = 0.0                     # theta = 0 branch
    xi[4:8, 3:] *= 1e-5                  # series branch
    return xi


def test_so3_se3_parity(twists):
    w = twists[:, 3:]
    np.testing.assert_allclose(n(tso3.exp(t(w))), n(jso3.exp(jnp.asarray(w))), atol=ATOL)
    R = np.asarray(jso3.exp(jnp.asarray(w)))
    np.testing.assert_allclose(n(tso3.log(t(R))), n(jso3.log(jnp.asarray(R))), atol=1e-4)
    np.testing.assert_allclose(n(tso3.mat_to_quat(t(R))), n(jso3.mat_to_quat(jnp.asarray(R))), atol=ATOL)
    q = np.asarray(jso3.mat_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(n(tso3.quat_to_mat(t(q))), n(jso3.quat_to_mat(jnp.asarray(q))), atol=ATOL)

    T = np.asarray(jse3.exp(jnp.asarray(twists)))
    np.testing.assert_allclose(n(tse3.exp(t(twists))), T, atol=ATOL)
    np.testing.assert_allclose(n(tse3.log(t(T))), n(jse3.log(jnp.asarray(T))), atol=1e-4)
    A, B = T[:32], T[32:]
    np.testing.assert_allclose(n(tse3.compose(t(A), t(B))),
                               n(jse3.compose(jnp.asarray(A), jnp.asarray(B))), atol=ATOL)
    np.testing.assert_allclose(n(tse3.inverse(t(A))), n(jse3.inverse(jnp.asarray(A))), atol=ATOL)
    x = np.random.default_rng(1).normal(0, 2, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tse3.apply(t(A), t(x))),
                               n(jse3.apply(jnp.asarray(A), jnp.asarray(x))), atol=1e-4)
    noisy = T + np.random.default_rng(2).normal(0, 1e-3, T.shape).astype(np.float32)
    np.testing.assert_allclose(n(tse3.orthonormalize(t(noisy))),
                               n(jse3.orthonormalize(jnp.asarray(noisy))), atol=ATOL)


def test_camera_parity():
    assert tuple(tcam.TUM3) == tuple(jcam.TUM3)
    rng = np.random.default_rng(3)
    xc = np.concatenate([rng.normal(0, 1, (100, 2)), rng.uniform(0.5, 5, (100, 1))], 1).astype(np.float32)
    uv = np.asarray(jcam.project(jcam.TUM3, jnp.asarray(xc)))
    np.testing.assert_allclose(n(tcam.project(tcam.TUM3, t(xc))), uv, atol=1e-3)
    np.testing.assert_array_equal(n(tcam.in_image(tcam.TUM3, t(uv), 5.0)),
                                  n(jcam.in_image(jcam.TUM3, jnp.asarray(uv), 5.0)))
    np.testing.assert_array_equal(n(tcam.TUM3.K()), n(jcam.TUM3.K))
    # a distorted lens exercises the fixed-point undistortion
    np.testing.assert_allclose(n(tcam.undistort_points(tcam.TUM1, t(uv))),
                               n(jcam.undistort_points(jcam.TUM1, jnp.asarray(uv))), atol=1e-3)


@pytest.mark.parametrize("name", ["TUM1", "TUM2"])
def test_distorted_presets_parity(name):
    """The TUM freiburg1/2 presets carry the reference's intrinsics and
    distortion, and undistort as the reference does (1e-3 px, as above)."""
    tc, jc = getattr(tcam, name), getattr(jcam, name)
    assert tuple(tc) == tuple(jc) and tc.has_distortion
    xn = np.random.default_rng(5).uniform(-0.3, 0.3, (256, 2)).astype(np.float32)
    np.testing.assert_allclose(n(tcam.distort_normalized(tc, t(xn))),
                               n(jcam.distort_normalized(jc, jnp.asarray(xn))), atol=ATOL)
    uv = xn * np.float32([tc.fx, tc.fy]) + np.float32([tc.cx, tc.cy])
    np.testing.assert_allclose(n(tcam.undistort_points(tc, t(uv))),
                               n(jcam.undistort_points(jc, jnp.asarray(uv))), atol=1e-3)


@pytest.mark.parametrize("name", ["TUM1", "TUM3"])
def test_backproject_parity(name):
    """backproject is the reference's three elementwise float32 operations:
    equal bit for bit; project(backproject) returns the pixels to 1e-3 px."""
    tc, jc = getattr(tcam, name), getattr(jcam, name)
    rng = np.random.default_rng(6)
    uv = rng.uniform(0, 640, (128, 2)).astype(np.float32)
    d = rng.uniform(0.5, 5.0, 128).astype(np.float32)
    xc = n(tcam.backproject(tc, t(uv), t(d)))
    np.testing.assert_array_equal(xc, n(jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(d))))
    np.testing.assert_allclose(n(tcam.project(tc, t(xc))), uv, atol=1e-3)


def _far_from_so3(seed):
    """Rotations scaled by distinct singular values in [0.5, 2] plus noise,
    a quarter of them reflected (det < 0), and translations."""
    rng = np.random.default_rng(seed)
    R = np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 1.0, (64, 3)), jnp.float32)))
    s = np.sort(rng.uniform(0.5, 2.0, (64, 3)), 1)[:, ::-1] * [1.0, 0.8, 0.6]
    M = (R * s[:, None, :] + rng.normal(0, 0.05, (64, 3, 3))).astype(np.float32)
    M[:16, :, 2] *= -1.0
    return np.concatenate([M, rng.normal(0, 2, (64, 3, 1))], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [7, 8])
def test_orthonormalize_svd_parity(seed):
    """The SVD projection onto SO(3): within 1e-5 of the reference (its
    LAPACK and torch's pick other singular-vector signs; the product is
    unique for distinct singular values), det +1 and R^T R = I."""
    T = _far_from_so3(seed)
    out = n(tse3.orthonormalize_svd(t(T)))
    np.testing.assert_allclose(out, n(jse3.orthonormalize_svd(jnp.asarray(T))), atol=ATOL)
    R = out[:, :, :3]
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    np.testing.assert_allclose(R.transpose(0, 2, 1) @ R, np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    np.testing.assert_array_equal(out[:, :, 3], T[:, :, 3])


def test_quat_trans_parity(twists):
    """to_quat_trans / from_quat_trans (wxyz, TUM order) against the
    reference's to 1e-5, and back to the pose."""
    T = np.asarray(jse3.exp(jnp.asarray(twists)))
    q, tr = tse3.to_quat_trans(t(T))
    jq, jt = jse3.to_quat_trans(jnp.asarray(T))
    np.testing.assert_allclose(n(q), n(jq), atol=ATOL)
    np.testing.assert_array_equal(n(tr), n(jt))
    assert (n(q)[:, 0] >= 0).all()
    back = n(tse3.from_quat_trans(q, tr))
    np.testing.assert_allclose(back, n(jse3.from_quat_trans(jq, jt)), atol=ATOL)
    np.testing.assert_allclose(back, T, atol=ATOL)


def test_rot_y_parity():
    """rot_y against the reference's to 1e-6 over yaws in [-2 pi, 2 pi],
    batched, and a rotation about Y (the Y row and column are e_y)."""
    yaw = np.random.default_rng(9).uniform(-2 * np.pi, 2 * np.pi, (4, 16)).astype(np.float32)
    R = n(tso3.rot_y(t(yaw)))
    assert R.shape == (4, 16, 3, 3)
    np.testing.assert_allclose(R, n(jso3.rot_y(jnp.asarray(yaw))), atol=1e-6)
    np.testing.assert_array_equal(R[..., 1, :], np.broadcast_to([0, 1, 0], R.shape[:-2] + (3,)))
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-6)


def test_triangulate_parity():
    rng = np.random.default_rng(4)
    cam_j, cam_t = jcam.TUM3, tcam.TUM3
    X = np.concatenate([rng.uniform(-1, 1, (200, 2)), rng.uniform(2, 5, (200, 1))], 1).astype(np.float32)
    T1 = np.eye(3, 4, dtype=np.float32)
    T2 = np.asarray(jse3.exp(jnp.asarray([0.2, 0.01, 0.02, 0.01, -0.05, 0.02], jnp.float32)))
    uv1 = np.asarray(jcam.project(cam_j, jse3.apply(jnp.asarray(T1), jnp.asarray(X))))
    uv2 = np.asarray(jcam.project(cam_j, jse3.apply(jnp.asarray(T2), jnp.asarray(X))))
    uv2 = uv2 + rng.normal(0, 0.5, uv2.shape).astype(np.float32)
    xn1 = jtri.pixels_to_normalized(cam_j, jnp.asarray(uv1))
    xn2 = jtri.pixels_to_normalized(cam_j, jnp.asarray(uv2))
    Xj = np.asarray(jtri.triangulate(jnp.asarray(T1)[None], jnp.asarray(T2)[None], xn1, xn2))
    Xt = n(ttri.triangulate(t(T1)[None], t(T2)[None], t(xn1), t(xn2)))
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-4)
    s2 = np.ones(200, np.float32)
    okj = np.asarray(jtri.check_triangulation(cam_j, jnp.asarray(T1), jnp.asarray(T2),
                                              jnp.asarray(Xj), jnp.asarray(uv1),
                                              jnp.asarray(uv2), jnp.asarray(s2)))
    okt = n(ttri.check_triangulation(cam_t, t(T1), t(T2), t(Xj), t(uv1), t(uv2), t(s2)))
    np.testing.assert_array_equal(okt, okj)
