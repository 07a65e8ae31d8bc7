"""The object layer's building blocks in the port against the reference
package: ``objects/boxes``, ``objects/stats``, ``objects/state``,
``objects/iforest``, ``io/tum`` and ``io/synthetic.project_boxes``, on the
same numpy inputs made from a seed.

Tolerances: integers and masks exact; floats 1e-5 (absolute, values of
order 1; relative for the t statistics, which divide by small spreads).
Inputs include ties (values quantized to a coarse grid), masked rows,
empty (zero-size) boxes and boxes at the image border. The iForest takes
the reference's own draws (``torch_objects.reference_iforest_draws``):
torch cannot replay ``jax.random``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eao_slam_tpu.objects import boxes as jb, iforest as jif, state as jstate, stats as jst
from eao_slam_torch.objects import boxes as tb, iforest as tif, state as tstate, stats as tst
from torch_objects import reference_iforest_draws
from torch_parity import n, t

W, H = 640.0, 480.0


def _boxes(rng, k):
    """k boxes on a 16-pixel grid (ties), some of zero size, some past the
    border."""
    x = rng.integers(-2, 40, k) * 16.0
    y = rng.integers(-2, 30, k) * 16.0
    w = rng.integers(0, 12, k) * 16.0
    h = rng.integers(0, 12, k) * 16.0
    return np.stack([x, y, w, h], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_overlaps_points_and_rects(seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 9), _boxes(rng, 7)
    for name in ("iou", "overlap_former", "overlap_latter", "pairwise_intersection"):
        np.testing.assert_allclose(n(getattr(tb, name)(t(a), t(b))),
                                   np.asarray(getattr(jb, name)(a, b)), atol=1e-5, err_msg=name)
    aa, bb = a[:, None], _boxes(rng, 9 * 4).reshape(9, 4, 4)
    for name in ("iou_elem", "overlap_former_elem", "intersection_elem"):
        np.testing.assert_allclose(n(getattr(tb, name)(t(aa), t(bb))),
                                   np.asarray(getattr(jb, name)(aa, bb)), atol=1e-5, err_msg=name)
    kp = (rng.integers(0, 40, (200, 2)) * 16.0).astype(np.float32)   # on box edges too
    np.testing.assert_array_equal(n(tb.points_in_box(t(kp), t(a))),
                                  np.asarray(jb.points_in_box(kp, a)))
    uv = rng.normal(300, 250, (5, 30, 2)).astype(np.float32)
    mask = rng.random((5, 30)) < 0.3
    mask[0] = False                                                   # an empty row
    np.testing.assert_allclose(n(tb.bbox_of_points(t(uv), t(mask), W, H)),
                               np.asarray(jb.bbox_of_points(uv, mask, W, H)), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_box_hygiene(seed):
    rng = np.random.default_rng(seed)
    B = 8
    bx = _boxes(rng, B)
    bx[1] = bx[0] + np.float32(2.0)          # a near duplicate
    bx[2] = [bx[0][0] + 4, bx[0][1] + 4, 16, 16]   # contained in box 0
    cls = rng.choice([0, 15, 56, 62, 63, 73], B).astype(np.int32)
    score = (rng.integers(5, 10, B) / 10).astype(np.float32)       # ties
    valid = rng.random(B) < 0.8
    npts = rng.integers(0, 30, B).astype(np.int32)
    np.testing.assert_array_equal(
        n(tb.box_hygiene(t(bx), t(cls), t(score), t(valid), t(npts), W, H)),
        np.asarray(jb.box_hygiene(bx, cls, score, valid, npts, W, H)))


@pytest.mark.parametrize("seed", [0, 1])
def test_rank_sum_with_ties_and_masks(seed):
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 6, (3, 4, 20, 3)) / 4).astype(np.float32)   # many ties
    b = (rng.integers(0, 6, (3, 4, 30, 3)) / 4).astype(np.float32)
    am, bm = rng.random((3, 4, 20)) < 0.7, rng.random((3, 4, 30)) < 0.6
    am[0, 0] = False                                                   # an empty sample
    wt, mt, nt = tst.rank_sum_statistic(t(a), t(am), t(b), t(bm))
    wj, mj, nj = jst.rank_sum_statistic(a, am, b, bm)
    np.testing.assert_array_equal(n(wt), np.asarray(wj))     # counts: exact in float32
    np.testing.assert_array_equal(n(mt), np.asarray(mj))
    np.testing.assert_array_equal(n(nt), np.asarray(nj))
    np.testing.assert_array_equal(n(tst.rank_sum_all_axes_pass(t(a), t(am), t(b), t(bm))),
                                  np.asarray(jst.rank_sum_all_axes_pass(a, am, b, bm)))


def test_t_statistics():
    rng = np.random.default_rng(0)
    c1, c2 = rng.normal(0, 1, (6, 5, 3)).astype(np.float32), rng.normal(0, 1, (5, 3)).astype(
        np.float32)
    s = np.abs(rng.normal(0, 0.1, (5, 3))).astype(np.float32)
    s[0] = 0.0                                                        # clamped spread
    df = rng.integers(0, 20, 5).astype(np.float32)
    np.testing.assert_allclose(n(tst.t_statistic_center(t(c1), t(c2), t(s), t(df))),
                               np.asarray(jst.t_statistic_center(c1, c2, s, df)), rtol=1e-5)
    n1, n2 = rng.integers(0, 30, 5).astype(np.float32), rng.integers(0, 30, 5).astype(np.float32)
    np.testing.assert_allclose(
        n(tst.two_sample_t_statistic(t(c2), t(s), t(n1), t(c2[::-1].copy()), t(s), t(n2))),
        np.asarray(jst.two_sample_t_statistic(c2, s, n1, c2[::-1], s, n2)), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_boxplot_depth_inliers(seed):
    rng = np.random.default_rng(seed)
    z = (rng.integers(0, 40, (6, 50)) / 8).astype(np.float32)        # ties
    z[:, :3] = 40.0                                                   # far outliers
    mask = rng.random((6, 50)) < 0.6
    mask[1] = False                                                   # masked row
    mask[2, 1:] = False                                               # one point
    np.testing.assert_array_equal(n(tst.boxplot_depth_inliers(t(z), t(mask))),
                                  np.asarray(jst.boxplot_depth_inliers(z, mask)))


def test_t_table_and_yolo_boxes(tmp_path):
    from eao_slam_tpu.io import tum as jtum
    from eao_slam_torch.io import tum as ttum

    np.testing.assert_array_equal(tst.make_t_table(), np.asarray(jst.make_t_table()))
    path = tmp_path / "t_test.txt"
    path.write_text("0 0.5 0.05\n1 1.0 12.7\n2 0.8 4.3 9\n")
    np.testing.assert_array_equal(ttum.load_t_table(str(path)), jtum.load_t_table(str(path)))
    ts = 1305031102.175304
    (tmp_path / f"{ts:.6f}.txt").write_text(
        "56 100 120 80 60 0.9\n62 -5 400 50 100 0.8\n73 630 10 30 20 0.3\n"
        "1 10 10 1 50 0.9\nbad line\n0 5 5 40 40 0.95\n")
    for min_score in (0.0, 0.5):
        for got, want in zip(ttum.load_yolo_boxes(str(tmp_path), ts, 4, min_score=min_score),
                             jtum.load_yolo_boxes(str(tmp_path), ts, 4, min_score=min_score)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(ttum.load_yolo_boxes(str(tmp_path), 1.0, 4),
                         jtum.load_yolo_boxes(str(tmp_path), 1.0, 4)):
        np.testing.assert_array_equal(got, want)          # no file: no boxes


def test_project_boxes_identical():
    from eao_slam_tpu.geometry.camera import TUM3 as JCAM
    from eao_slam_tpu.io import synthetic as jsyn
    from eao_slam_torch.geometry.camera import TUM3 as TCAM
    from eao_slam_torch.io import synthetic as tsyn

    kw = dict(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
    sj, st = jsyn.make_room_scene(**kw), tsyn.make_room_scene(**kw)
    _, Ts = tsyn.make_arc_trajectory(n_frames=30, sweep_deg=80.0)
    for T in Ts[::3]:
        for got, want in zip(tsyn.project_boxes(st, TCAM, T, 2), jsyn.project_boxes(sj, JCAM, T, 2)):
            np.testing.assert_array_equal(got, want)


def test_object_table_state():
    rng = np.random.default_rng(0)
    tj, tt = jstate.empty_object_table(6), tstate.empty_object_table(6)
    assert tt._fields == tj._fields and len(tt._fields) == 21
    for f in tj._fields:
        assert n(getattr(tt, f)).dtype == np.asarray(getattr(tj, f)).dtype, f
        np.testing.assert_array_equal(n(getattr(tt, f)), np.asarray(getattr(tj, f)), err_msg=f)
    yaw = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    np.testing.assert_allclose(n(tstate.yaw_rotation(t(yaw))),
                               np.asarray(jstate.yaw_rotation(yaw)), atol=1e-6)
    upd = dict(yaw=yaw, center=rng.normal(0, 2, (6, 3)).astype(np.float32),
               cub_min=-rng.uniform(0, 1, (6, 3)).astype(np.float32),
               cub_max=rng.uniform(0, 1, (6, 3)).astype(np.float32))
    got = tstate.cuboid_corners(tt._replace(**{k: t(v) for k, v in upd.items()}))
    want = jstate.cuboid_corners(tj._replace(**{k: jnp.asarray(v) for k, v in upd.items()}))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n_points_cap,N", [(192, 512), (32, 100), (16, 40)])
def test_anomaly_scores_with_reference_draws(n_points_cap, N):
    """Scores of one forest per row, on clustered points with outliers and
    masked slots, at the psi / depth of three sample sizes (96 / 7, 16 / 4,
    8 / 3), from the reference's draws: 1e-5."""
    import jax

    psi, depth = tif.psi_depth_for(n_points_cap)
    assert (psi, depth) == jif.psi_depth_for(n_points_cap)
    rng = np.random.default_rng(n_points_cap)
    pts = rng.normal(0, 0.2, (3, N, 3)).astype(np.float32)
    pts[:, :5] += 3.0                                                 # outliers
    pts[1] = np.round(pts[1] * 4) / 4                                 # ties
    mask = rng.random((3, N)) < 0.9
    key = jax.random.PRNGKey(n_points_cap)
    draws = reference_iforest_draws(key, mask, psi, depth)
    got = n(tif.anomaly_scores(t(pts), t(mask), draws, depth))
    keys = jax.random.split(key, 3)
    want = np.stack([np.asarray(jif.anomaly_scores(keys[r], pts[r], mask[r], 50, psi, depth))
                     for r in range(3)])
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[:, :5].mean() > got[:, 5:][mask[:, 5:]].mean())


def test_port_draws_are_seeded_and_weighted_to_valid_points():
    """The port's own draws: the same generator seed gives the same draws;
    the subsample takes valid points only (an all-invalid row is scored 0
    whatever it draws)."""
    mask = torch.zeros((2, 50), dtype=torch.bool)
    mask[0, 10:20] = True
    d1 = tif.draw_iforest(torch.Generator().manual_seed(3), mask, 16, 4)
    d2 = tif.draw_iforest(torch.Generator().manual_seed(3), mask, 16, 4)
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    assert d1.sub_idx.shape == (2, 50, 16) and d1.dims.shape == (2, 4, 50, 16)
    assert ((d1.sub_idx[0] >= 10) & (d1.sub_idx[0] < 20)).all()
    assert int(d1.dims.max()) <= 2
    scores = tif.anomaly_scores(torch.randn(2, 50, 3), mask, d1, 4)
    assert (scores[1] == 0).all() and (scores[0, 10:20] > 0).all()


def test_port_draws_follow_the_reference_draw_distribution():
    """The port's own iForest draws (``draw_iforest``: a host generator, the
    inverse CDF of the valid points' weights) against the reference's
    (``jax.random.choice(p=...)``, ``randint``, ``uniform``), 200 forests
    each on one seeded mask of 300 slots, 268 valid: the subsample's share
    of every valid point, the split dimensions and the split fractions are
    draws of one distribution (chi-square and Kolmogorov-Smirnov p > 1e-3;
    measured 0.84, 0.38, 0.28), no draw lands on an invalid slot, and the
    members the cull's threshold of 0.6 keeps per forest, on a box of points
    with a halo of stragglers, agree in mean to 0.5 point (measured 252.10
    and 251.92, sd 1.7) with Mann-Whitney p > 1e-3 (measured 0.32)."""
    import jax
    from scipy.stats import chi2_contingency, ks_2samp, mannwhitneyu

    rng = np.random.default_rng(21)
    N, F = 300, 200
    psi, depth = tif.psi_depth_for(192)
    mask = rng.random(N) < 0.9
    pts = rng.uniform(-0.15, 0.15, (N, 3)).astype(np.float32)
    pts[:40] *= rng.uniform(1.5, 3.0, (40, 1)).astype(np.float32)      # stragglers
    rows = np.broadcast_to(mask, (F, N))
    ours = tif.draw_iforest(torch.Generator().manual_seed(21), t(rows), psi, depth)
    ref = reference_iforest_draws(jax.random.PRNGKey(21), rows, psi, depth)
    valid = np.flatnonzero(mask)
    counts = [np.bincount(n(d.sub_idx).ravel(), minlength=N) for d in (ours, ref)]
    assert all(c[~mask].sum() == 0 for c in counts)
    assert chi2_contingency(np.stack([c[valid] for c in counts]))[1] > 1e-3
    dims = [np.bincount(n(d.dims).ravel(), minlength=3) for d in (ours, ref)]
    assert chi2_contingency(np.stack(dims))[1] > 1e-3
    assert ks_2samp(n(ours.fracs).ravel()[::97], n(ref.fracs).ravel()[::97]).pvalue > 1e-3
    P = t(np.broadcast_to(pts, (F, N, 3)).copy())
    kept = [n(((tif.anomaly_scores(P, t(rows), d, depth) < 0.6) & t(rows)).sum(1))
            for d in (ours, ref)]
    assert abs(kept[0].mean() - kept[1].mean()) < 0.5
    assert mannwhitneyu(*kept).pvalue > 1e-3
