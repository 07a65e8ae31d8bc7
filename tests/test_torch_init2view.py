"""Parity of two-view initialization with eao_slam_tpu.solvers.init2view.

Trouble spot named here: RANSAC randomness. The reference draws its
hypotheses with ``jax.random.choice``, whose stream torch cannot replay.
The test draws the reference's indices with the same key and hands them
to the port (``hyp_idx``), so both solve the same 256 minimal samples.

Tolerances: the batched eigen/SVD solves run in float32 in another order,
so the elected pose agrees to 1e-3 (rotation entries; unit translation)
and the triangulated points to 1e-2 relative depth. The success flag and
the model choice (H or F) are exact; a correspondence whose symmetric
transfer error sits on the chi2 gate can flip, so the inlier counts agree
to 1 %. The failing scene (cheirality election ambiguous) fails in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.solvers import init2view as jinit
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.solvers import init2view as tinit
from torch_parity import n, t


def _two_view(seed: int, planar: bool):
    rng = np.random.default_rng(seed)
    M = 300
    if planar:
        X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M), np.full(M, 4.0)], 1)
    else:
        X = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M), rng.uniform(3, 7, M)], 1)
    a = 0.06
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    tvec = np.array([-0.35, 0.02, 0.05])

    def proj(Xc):
        return np.stack([TCAM.fx * Xc[:, 0] / Xc[:, 2] + TCAM.cx,
                         TCAM.fy * Xc[:, 1] / Xc[:, 2] + TCAM.cy], 1)

    uv1 = proj(X) + rng.normal(0, 0.5, (M, 2))
    uv2 = proj(X @ R.T + tvec) + rng.normal(0, 0.5, (M, 2))
    uv2[:25] += rng.uniform(-30, 30, (25, 2))          # outliers
    valid = rng.random(M) < 0.93
    return uv1.astype(np.float32), uv2.astype(np.float32), valid


@pytest.mark.parametrize("seed,planar,succeeds", [(4, False, True), (4, True, True),
                                                  (3, False, False)])
def test_initialize_two_view_with_injected_hypotheses(seed, planar, succeeds):
    uv1, uv2, valid = _two_view(seed, planar)
    key = jax.random.PRNGKey(7)
    rj = jinit.initialize_two_view(JCAM, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid),
                                   key, min_triangulated=50)
    # the reference's own draw (init2view.py: jax.random.choice over valid rows)
    p = jnp.asarray(valid, jnp.float32) / jnp.maximum(jnp.sum(valid), 1)
    idx = jax.random.choice(key, uv1.shape[0], shape=(256, 8), p=p)
    rt = tinit.initialize_two_view(TCAM, t(uv1), t(uv2), t(valid), hyp_idx=t(idx),
                                   min_triangulated=50)

    assert bool(rj.success) == succeeds
    assert bool(rt.success) == bool(rj.success)
    assert bool(rt.used_h) == bool(rj.used_h)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 0.01 * int(rj.n_inliers)
    Tj, Tt = np.asarray(rj.T21), n(rt.T21)
    np.testing.assert_allclose(Tt, Tj, atol=1e-3)
    if not succeeds:
        return
    ok = np.asarray(rj.point_ok) & n(rt.point_ok)
    assert ok.sum() >= 0.98 * np.asarray(rj.point_ok).sum()
    Pj, Pt = np.asarray(rj.points)[ok], n(rt.points)[ok]
    np.testing.assert_allclose(Pt, Pj, rtol=1e-2, atol=1e-3 * np.abs(Pj).max())


def test_generator_draws_only_valid_rows_and_is_seeded():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[::3] = True
    a = tinit.sample_hypotheses(valid, 64, torch.Generator().manual_seed(1))
    b = tinit.sample_hypotheses(valid, 64, torch.Generator().manual_seed(1))
    assert a.shape == (64, 8)
    assert torch.equal(a, b)
    assert bool(valid[a].all())


def test_rendered_pair_with_reference_draws():
    """The bench arc's frames 0 and 4 (chip_smoke.py's interactive
    protocol, seed 12345: the reference initializes from this pair at its
    fourth attempt), rendered once: each package's ORB front end and
    match_for_init, then the reference's initialize_two_view on the key its
    tracker splits for that attempt, and the port's on the reference's
    hypothesis indices. The valid-match masks, success and ``point_ok`` are
    exact, the pose agrees to 1e-4 and the points to 2e-4 of their depth:
    in the pair's frame the baseline is one unit and the points lie about
    50 units away, so triangulation amplifies the pose's float32 difference
    (measured 1.6e-4 at most)."""
    from eao_slam_torch.config import CapacityConfig as TC, tum3_config as tt
    from eao_slam_torch.io.synthetic import make_arc_trajectory, make_room_scene, render_image
    from eao_slam_torch.runtime import tracking_kernels as ttk
    from eao_slam_torch.runtime.frame import frame_from_image as t_frame
    from eao_slam_tpu.config import CapacityConfig as JC, tum3_config as jt
    from eao_slam_tpu.runtime import tracking_kernels as jtk
    from eao_slam_tpu.runtime.frame import frame_from_image as j_frame

    scene = make_room_scene(seed=5, n_landmarks=200, n_objects=3, obj_z_range=(4.0, 5.2))
    _, gt = make_arc_trajectory(n_frames=168, sweep_deg=60.0)
    imgs = [render_image(scene, TCAM, gt[k]) for k in (0, 4)]
    cap = dict(max_keyframes=128, max_points=8192, max_features=1024, local_ba_points=2048)
    jc, tc = jt().replace(capacity=JC(**cap)), tt().replace(capacity=TC(**cap))
    jf = [j_frame(jc, im.astype(np.float32)) for im in imgs]
    tf = [t_frame(tc, im, "cpu") for im in imgs]
    jidx, _, jok = jtk.match_for_init(*(getattr(jf[0], a) for a in ("kp", "desc", "angle", "valid")),
                                      *(getattr(jf[1], a) for a in ("kp", "desc", "angle", "valid")))
    tidx, _, tok = ttk.match_for_init(*(getattr(tf[0], a) for a in ("kp", "desc", "angle", "valid")),
                                      *(getattr(tf[1], a) for a in ("kp", "desc", "angle", "valid")))
    np.testing.assert_array_equal(n(tok), np.asarray(jok))
    assert int(np.asarray(jok).sum()) >= jc.tracking.min_init_matches
    key = jax.random.PRNGKey(12345)
    for _ in range(4):                  # the tracker's split for its fourth attempt
        key, sub = jax.random.split(key)
    uv2 = jf[1].kp[jidx]
    rj = jinit.initialize_two_view(JCAM, jf[0].kp, uv2, jok, sub,
                                   min_triangulated=jc.tracking.min_init_matches // 2)
    p = jok.astype(jnp.float32) / jnp.maximum(jnp.sum(jok), 1)
    hyp = jax.random.choice(sub, jok.shape[0], shape=(256, 8), p=p)
    rt = tinit.initialize_two_view(TCAM, tf[0].kp, tf[1].kp[tidx.long()], tok, hyp_idx=t(hyp),
                                   min_triangulated=tc.tracking.min_init_matches // 2)
    assert bool(rt.success) == bool(rj.success) is True
    np.testing.assert_array_equal(n(rt.point_ok), np.asarray(rj.point_ok))
    assert int(np.asarray(rj.point_ok).sum()) > 300
    np.testing.assert_allclose(n(rt.T21), np.asarray(rj.T21), atol=1e-4)
    ok = np.asarray(rj.point_ok)
    want = np.asarray(rj.points)[ok]
    rel = np.abs(n(rt.points)[ok] - want).max(1) / np.abs(want[:, 2])
    assert rel.max() <= 2e-4, rel.max()


# ---------------------------------------------------------------------------
# the recorded attempts: where the two packages part on the same draws
# ---------------------------------------------------------------------------

FIXTURES = {4: "init2view_seed4_frame4.npz", 12345: "init2view_seed12345_frame4.npz"}


def _attempt(seed: int) -> dict:
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), FIXTURES[seed])
    return dict(np.load(path))


def _up_to_sign(a, b) -> np.ndarray:
    """Per hypothesis, the largest entry difference of two [B, 3, 3]
    stacks, each pair taken with the sign that matches them best."""
    a = np.asarray(a).reshape(len(a), -1)
    b = np.asarray(b).reshape(len(b), -1)
    s = np.where((a * b).sum(1, keepdims=True) < 0, -1.0, 1.0)
    return np.abs(a - s * b).max(1)


def _f_normal_matrices(n1, n2, hyp) -> np.ndarray:
    """The F hypotheses' A^T A in float64 from the reference's normalized
    points: the system whose smallest eigenvector each package takes."""
    p1 = np.asarray(n1, np.float64)[hyp]
    p2 = np.asarray(n2, np.float64)[hyp]
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)], -1)
    return np.swapaxes(A, -1, -2) @ A


def _decision(res) -> tuple:
    return bool(res.success), int(res.n_inliers), int(np.asarray(res.point_ok).sum())


@pytest.mark.parametrize("seed", [4, 12345])
def test_recorded_attempt_parts_at_the_f_hypotheses(seed, monkeypatch):
    """Two attempts the reference's interactive tracker made on the bench
    arc (``reference_ate_spread.py --interactive --record-init``, frame 4 of
    RANSAC seeds 4 and 12345): the matched pixels, the valid mask and the
    [256, 8] hypothesis indices its key draws. Stage by stage, on the same
    arrays (the reference's private functions called eagerly):

    - ``normalize_points`` and the 256 homographies agree to float32 noise
      (1e-6 and, up to sign, 1e-4), and both packages elect the same H;
    - the 256 fundamental matrices part. Each is the smallest eigenvector
      of an 8-point A^T A, which has rank 8: the next eigenvalue is 2.6e-7
      (seed 4; 3.9e-7 on seed 12345) of the largest, at float32
      resolution, so the eigenvector is float32 noise. The two packages'
      A^T A agree to 1e-6 of their largest entry, yet their eigenvectors
      differ by more than 1e-3 on most hypotheses, and each lies as far
      from the float64 eigenvector as from the other package's;
    - given the reference's F hypotheses (the port's ``_solve_f_batch``
      replaced), the port's later stages (the F scores and their argmax,
      the two refit rounds, RH, the 12 candidates' cheirality counts and
      parallax, the uniqueness test and ``min_good``) reach the decision the
      reference reaches eagerly on the same arrays: success, inliers and
      points exact, the rotation to 2e-4 and the unit translation to 0.02
      (measured 7e-5 / 9e-5 and 0.005 / 0.010: the refits' eigenvectors
      carry float32 noise too).

    So the disagreement is float32 noise amplified by discrete choices, and
    is pinned, not repaired. Seed 4 (the reference elects F with 403
    inliers and 398 points; the port, on its own F hypotheses, finds 399
    inliers and fails a gate): the reference's best two F scores lie 0.47 %
    apart, and the port's best hypothesis is another one. Seed 12345: the
    port agrees with the reference's jitted program (success, 398 inliers,
    393 points), while the same reference code run eagerly fails there
    (400 inliers: the H and E candidates of one rotation 33 degrees apart
    in translation count as two distinct solutions): the reference's own
    float32 rounding flips this decision too."""
    d = _attempt(seed)
    uv1, uv2, valid, hyp = d["uv1"], d["uv2"], d["valid"], d["hyp_idx"]
    mt = int(d["min_triangulated"])
    ju1, ju2, jv = jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid)

    jn1, jT1 = jinit.normalize_points(ju1, jv)
    jn2, jT2 = jinit.normalize_points(ju2, jv)
    tn1, tT1 = tinit.normalize_points(t(uv1), t(valid))
    tn2, tT2 = tinit.normalize_points(t(uv2), t(valid))
    for a, b in ((jn1, tn1), (jn2, tn2), (jT1, tT1), (jT2, tT2)):
        np.testing.assert_allclose(n(b), np.asarray(a), atol=1e-6)

    js1, js2 = jn1[jnp.asarray(hyp)], jn2[jnp.asarray(hyp)]
    ts1, ts2 = tn1[t(hyp).long()], tn2[t(hyp).long()]
    jH = jnp.linalg.inv(jT2)[None] @ jinit._solve_h_batch(js1, js2) @ jT1[None]
    tH = torch.linalg.inv(tT2)[None] @ tinit._solve_h_batch(ts1, ts2) @ tT1[None]
    assert _up_to_sign(jinit._solve_h_batch(js1, js2), tinit._solve_h_batch(ts1, ts2)).max() < 1e-4
    jhs = np.asarray(jinit._score_h(jH, ju1, ju2, jv, 1.0)[0])
    ths = n(tinit._score_h(tH, t(uv1), t(uv2), t(valid), 1.0)[0])
    assert int(np.argmax(jhs)) == int(np.argmax(ths))

    jFn = np.asarray(jinit._solve_f_batch(js1, js2))
    tFn = n(tinit._solve_f_batch(ts1, ts2))
    AtA = _f_normal_matrices(jn1, jn2, hyp)
    w = np.linalg.eigvalsh(AtA)
    assert np.median(w[:, 1] / w[:, -1]) < 1e-6          # measured 2.6e-7, 3.9e-7
    f64 = np.linalg.eigh(AtA)[1][..., :, 0].reshape(-1, 3, 3)
    unit = [f / np.linalg.norm(f.reshape(len(f), -1), axis=1)[:, None, None] for f in (jFn, tFn)]
    between = _up_to_sign(*unit)
    assert np.mean(between > 1e-3) > 0.8                 # measured 0.96 (seed 4)
    for u in unit:
        assert np.median(_up_to_sign(u, f64)) > 1e-3     # measured 0.013 (reference), 0.017
    # the rank-2 projection does not part them: given the same unit vector
    # both packages' SVD gives the same F to float32 noise
    same = n(tinit._rank2(t(np.asarray(jinit._solve_f_batch(js1, js2)))))
    assert _up_to_sign(same, jFn).max() < 1e-4

    jfs = np.sort(np.asarray(jinit._score_f(jT2.T[None] @ jnp.asarray(jFn) @ jT1[None],
                                            ju1, ju2, jv, 1.0)[0]))[::-1]
    gap = (jfs[0] - jfs[1]) / jfs[0]
    key = jnp.asarray(d["key"])
    ref_jit = _decision(jinit.initialize_two_view(JCAM, ju1, ju2, jv, key, min_triangulated=mt))
    with jax.disable_jit():
        ref_eager = jinit.initialize_two_view(JCAM, ju1, ju2, jv, key, min_triangulated=mt)
    port = _decision(tinit.initialize_two_view(TCAM, t(uv1), t(uv2), t(valid), hyp_idx=t(hyp),
                                               min_triangulated=mt))
    monkeypatch.setattr(tinit, "_solve_f_batch", lambda p1, p2: t(jFn))
    fed = tinit.initialize_two_view(TCAM, t(uv1), t(uv2), t(valid), hyp_idx=t(hyp),
                                    min_triangulated=mt)
    assert _decision(fed) == _decision(ref_eager)
    dT = np.abs(n(fed.T21) - np.asarray(ref_eager.T21))
    assert dT[:, :3].max() < 2e-4 and dT[:, 3].max() < 0.02
    if seed == 4:
        assert ref_jit == (True, 403, 398) and port == (False, 399, 0)
        assert gap < 0.01                                # measured 0.0047
    else:
        assert ref_jit == port == (True, 398, 393)
        assert _decision(ref_eager) == (False, 400, 0)
