"""Parity of the port's 3D line stage (eao_slam_torch/dense/lines3d.py) with
the reference's, on the CPU.

Tolerances: ``fit_3d_segments`` valid masks exact and endpoints to 1e-4 m
as unordered pairs (a fitted direction has no fixed sign, so either
package may return a segment's endpoints swapped); ``segment_affinity``
exact wherever the angle and the distances sit further than 1e-5 from
their thresholds; ``cluster_world_segments`` the same clusters and merged
segments to 1e-5 as unordered pairs; ``save_lines_obj`` byte-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import n, t  # one torch thread per test worker

from eao_slam_tpu.dense import lines3d as J
from eao_slam_torch.dense import lines3d as P
from eao_slam_torch.geometry.camera import TUM3


def unordered_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per row, the largest endpoint difference of two [.., 6] segment
    sets, taking either order of b's endpoints."""
    return np.minimum(np.abs(a - b).max(-1), np.abs(a - b[..., [3, 4, 5, 0, 1, 2]]).max(-1))


def line_scene(seed: int, n_lines: int = 24, T=None):
    """n_lines 3D segments 3-6 m ahead, their projected 2D segments and
    noisy semi-dense samples along them (tests/test_lines3d.py's scene,
    several lines, some outside the image, some without depth)."""
    rng = np.random.default_rng(seed)
    if T is None:
        T = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    segs, pxs, rhos = [], [], []
    for k in range(n_lines):
        p1 = np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.0, 1.0), rng.uniform(3, 6)])
        p2 = p1 + rng.normal(0, 0.7, 3)
        s = np.linspace(0, 1, 300)
        Xw = p1 + s[:, None] * (p2 - p1)
        Xc = Xw @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([TUM3.fx * Xc[:, 0] / Xc[:, 2] + TUM3.cx,
                       TUM3.fy * Xc[:, 1] / Xc[:, 2] + TUM3.cy], -1)
        segs.append([uv[0, 0], uv[0, 1], uv[-1, 0], uv[-1, 1]])
        if k % 6 != 5:                                 # every sixth line has no depth
            pxs.append(uv)
            rhos.append(1.0 / Xc[:, 2] * (1.0 + rng.normal(0, 0.003, len(Xc))))
    px = np.concatenate(pxs)
    keep = (px[:, 0] >= 0) & (px[:, 0] < 640) & (px[:, 1] >= 0) & (px[:, 1] < 480)
    px = np.where(keep[:, None], px, 0.0).astype(np.float32)
    valid = rng.random(n_lines) < 0.9
    return (np.asarray(segs, np.float32), valid, px, np.concatenate(rhos).astype(np.float32),
            keep, T)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_3d_segments_matches_reference(seed):
    T = None
    if seed == 2:
        from eao_slam_torch.io.synthetic import look_at

        T = look_at(np.array([0.3, -0.2, 0.5]), np.array([0.0, 0.0, 4.5])).astype(np.float32)
    segs, valid, px, rho, pxv, T = line_scene(seed, T=T)
    want = J.fit_3d_segments(TUM3, jnp.asarray(segs), jnp.asarray(valid), jnp.asarray(px),
                             jnp.asarray(rho), jnp.asarray(pxv), jnp.asarray(T))
    got = P.fit_3d_segments(TUM3, t(segs), t(valid), t(px), t(rho), t(pxv), t(T))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(n(got.valid), v)
    assert 5 <= v.sum() < len(v)
    assert unordered_diff(n(got.seg)[v], np.asarray(want.seg)[v]).max() < 1e-4


def test_fit_recovers_the_references_segment():
    """tests/test_lines3d.py's recovery fixture on the port."""
    rng = np.random.default_rng(12345)
    T = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    p1, p2 = np.array([-0.8, -0.2, 4.0]), np.array([0.9, 0.4, 5.0])
    s = np.linspace(0, 1, 400)
    X = p1[None] + s[:, None] * (p2 - p1)[None]
    uv = np.stack([TUM3.fx * X[:, 0] / X[:, 2] + TUM3.cx, TUM3.fy * X[:, 1] / X[:, 2] + TUM3.cy],
                  -1).astype(np.float32)
    rho = (1.0 / X[:, 2] * (1.0 + rng.normal(0, 0.003, len(X)))).astype(np.float32)
    segs = np.zeros((8, 4), np.float32)
    segs[0] = [uv[0, 0], uv[0, 1], uv[-1, 0], uv[-1, 1]]
    segs[1] = (50, 50, 200, 60)                       # no depth there
    valid = np.zeros(8, bool)
    valid[:2] = True
    got = P.fit_3d_segments(TUM3, t(segs), t(valid), t(uv), t(rho), t(np.ones(len(uv), bool)),
                            t(T))
    assert n(got.valid).tolist() == [True] + [False] * 7
    assert unordered_diff(n(got.seg[0]), np.concatenate([p1, p2])) < 0.1


def test_segment_affinity_matches_reference_away_from_thresholds():
    rng = np.random.default_rng(7)
    base = rng.uniform(-2, 2, (30, 6)).astype(np.float32)
    # near copies of the base segments: some within the tolerances, some
    # just outside, plus unrelated ones
    copies = base + rng.normal(0, 0.03, base.shape).astype(np.float32)
    seg = np.concatenate([base, copies, rng.uniform(-2, 2, (20, 6))]).astype(np.float32)
    valid = rng.random(len(seg)) < 0.9
    want = np.asarray(J.segment_affinity(jnp.asarray(seg), jnp.asarray(valid)))
    got = n(P.segment_affinity(t(seg), t(valid)))
    # margins of the three tests, in float64
    d = seg[:, 3:] - seg[:, :3]
    nn = d / np.linalg.norm(d, axis=1, keepdims=True)
    cos = np.abs(nn @ nn.T)
    mid = 0.5 * (seg[:, :3] + seg[:, 3:])
    rel = mid[:, None] - seg[None, :, :3]
    perp = rel - (rel * nn[None]).sum(-1)[..., None] * nn[None]
    dist = np.linalg.norm(perp, axis=-1)
    clear = ((np.abs(cos - np.cos(np.deg2rad(5.0))) > 1e-5) & (np.abs(dist - 0.08) > 1e-5)
             & (np.abs(dist.T - 0.08) > 1e-5))
    np.testing.assert_array_equal(got[clear], want[clear])
    assert want[clear].sum() > len(base)


def clustered_segments(seed: int):
    """Several physical lines, each observed 2-4 times with noise and
    partial extent, plus single-view lines that min_views drops."""
    rng = np.random.default_rng(seed)
    segs = []
    for _ in range(6):
        p1 = rng.uniform(-2, 2, 3) + np.array([0, 0, 4.0])
        p2 = p1 + rng.normal(0, 0.8, 3)
        for _ in range(rng.integers(1, 5)):
            a, b = rng.uniform(0.0, 0.2), rng.uniform(0.8, 1.0)
            segs.append(np.concatenate([p1 + a * (p2 - p1) + rng.normal(0, 0.01, 3),
                                        p1 + b * (p2 - p1) + rng.normal(0, 0.01, 3)]))
    seg = np.asarray(segs, np.float32)[rng.permutation(len(segs))]
    return seg, rng.random(len(seg)) < 0.95


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_world_segments_matches_reference(seed, tmp_path):
    seg, valid = clustered_segments(seed)
    want = J.cluster_world_segments(seg, valid, min_views=2)
    got = P.cluster_world_segments(seg, valid, min_views=2, device="cpu")
    assert got.shape == want.shape and len(want) >= 2
    assert unordered_diff(got, want).max() < 1e-5
    a, b = tmp_path / "ref.obj", tmp_path / "port.obj"
    assert J.save_lines_obj(str(a), want) == P.save_lines_obj(str(b), want) == len(want)
    assert a.read_bytes() == b.read_bytes()
