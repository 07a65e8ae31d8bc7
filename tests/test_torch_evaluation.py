"""Parity of the port's reconstruction evaluation (eao_slam_torch/evaluation.py)
with the reference's, on the CPU.

Tolerances: the file loaders and the downsamplers exact (the same numpy);
``nearest_neighbors`` indices exact on clouds without near ties and the
distances to 1e-5 (a float32 distance tile in both, products in full
float32); ``icp_register`` (s, R, t) to 1e-4; ``evaluate_reconstruction``
on the same files: scale and mean distance to 1e-4 relative, counts
exact.
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test worker)

from eao_slam_tpu import evaluation as J
from eao_slam_torch import evaluation as P


def room_cloud(rng, n: int = 800) -> np.ndarray:
    """tests/test_evaluation.py's cloud: three walls of a room."""
    a = np.stack([rng.uniform(0, 2, n), rng.uniform(0, 2, n), np.zeros(n)], 1)
    b = np.stack([np.zeros(n), rng.uniform(0, 2, n), rng.uniform(0, 2, n)], 1)
    c = np.stack([rng.uniform(0, 2, n), np.zeros(n), rng.uniform(0, 2, n)], 1)
    return np.concatenate([a, b, c])


def moved(cloud, rng, scale=2.5, ang=0.4, noise=0.002):
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    dst = (scale * (R @ cloud.T)).T + np.array([0.3, -0.2, 0.5])
    return dst, cloud + rng.normal(scale=noise, size=cloud.shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_nearest_neighbors_match_reference(seed):
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(3000, 3))
    q = rng.normal(size=(5000, 3))
    ij, dj = J.nearest_neighbors(q, ref)
    ip, dp = P.nearest_neighbors(q, ref, device="cpu")
    # pairs whose best two candidates are within float32 noise are ties
    d = np.linalg.norm(q[:, None] - ref[None], axis=-1)
    two = np.sort(d, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 1e-4
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(ip[clear], ij[clear])
    np.testing.assert_allclose(dp, dj, rtol=0, atol=1e-5)
    assert list(P.nearest_neighbors(ref[[3, 77, 200]] + 1e-4, ref, device="cpu")[0]) == [
        3, 77, 200]


def test_icp_register_matches_reference():
    rng = np.random.default_rng(12345)
    cloud = room_cloud(rng)
    dst, src = moved(cloud, rng)
    sj, Rj, tj = J.icp_register(src, dst, iters=50)
    sp, Rp, tp = P.icp_register(src, dst, iters=50, device="cpu")
    assert abs(sp - sj) < 1e-4 and np.abs(Rp - Rj).max() < 1e-4 and np.abs(tp - tj).max() < 1e-4
    assert abs(sp - 2.5) < 0.05
    assert abs(P.mean_cloud_distance(src, dst, (sp, Rp, tp), device="cpu")
               - J.mean_cloud_distance(src, dst, (sj, Rj, tj))) < 1e-5


def test_downsample_and_loaders_match_reference(tmp_path):
    rng = np.random.default_rng(2)
    cloud = room_cloud(rng, 300)
    np.testing.assert_array_equal(P.random_downsample(cloud, 0.25, seed=3),
                                  J.random_downsample(cloud, 0.25, seed=3))
    np.testing.assert_array_equal(P.voxel_downsample(cloud, 0.5), J.voxel_downsample(cloud, 0.5))
    obj, ply, xyz = tmp_path / "c.obj", tmp_path / "c.ply", tmp_path / "c.xyz"
    obj.write_text("# cloud\n" + "".join(f"v {x:.5f} {y:.5f} {z:.5f}\n" for x, y, z in cloud)
                   + "f 1 2 3\n")
    ply.write_text(f"ply\nformat ascii 1.0\nelement vertex {len(cloud)}\nproperty float x\n"
                   "property float y\nproperty float z\nend_header\n"
                   + "".join(f"{x} {y} {z}\n" for x, y, z in cloud))
    np.savetxt(xyz, cloud)
    for path in (obj, ply, xyz):
        np.testing.assert_array_equal(P.load_cloud(str(path)), J.load_cloud(str(path)))


def test_evaluate_reconstruction_matches_reference(tmp_path):
    rng = np.random.default_rng(4)
    cloud = room_cloud(rng, 1500)
    dst, src = moved(cloud, rng, scale=0.4, ang=0.2, noise=0.005)
    est, gt = tmp_path / "est.obj", tmp_path / "gt.xyz"
    est.write_text("".join(f"v {x:.5f} {y:.5f} {z:.5f}\n" for x, y, z in src))
    np.savetxt(gt, dst)
    want = J.evaluate_reconstruction(str(est), str(gt))
    got = P.evaluate_reconstruction(str(est), str(gt), device="cpu")
    assert (got["n_est"], got["n_gt"]) == (want["n_est"], want["n_gt"])
    assert abs(got["scale"] - want["scale"]) <= 1e-4 * want["scale"]
    assert abs(got["mean_distance"] - want["mean_distance"]) <= 1e-4 * want["mean_distance"]
    assert want["mean_distance"] < 0.01
