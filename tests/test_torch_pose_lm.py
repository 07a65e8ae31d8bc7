"""Parity of the robust pose LM and the per-frame tracking steps.

The LM runs the same float32 schedule in both packages; sums are taken in
another order, so poses agree to 1e-4 (rotation entries and metres on a
unit-scale map) and inlier sets exactly on these well-conditioned inputs.
The tracking steps run on the reference's bootstrapped map and the next
rendered frame: match sets (integers) are exact, poses within 1e-4."""

import jax.numpy as jnp
import numpy as np

from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.ops.orb import scale_sigma2
from eao_slam_tpu.runtime import tracking_kernels as jtk
from eao_slam_tpu.solvers import pose_lm as jlm
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.runtime import tracking_kernels as ttk
from eao_slam_torch.solvers import pose_lm as tlm
from torch_parity import jax_bootstrap, n, t


def test_optimize_pose_parity():
    rng = np.random.default_rng(0)
    N = 400
    X = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(2, 6, (N, 1))], 1).astype(np.float32)
    T_true = np.eye(3, 4, dtype=np.float32)
    T_true[:, 3] = [0.05, -0.02, 0.03]
    xc = X + T_true[:, 3]
    uv = np.stack([535.4 * xc[:, 0] / xc[:, 2] + 320.1, 539.2 * xc[:, 1] / xc[:, 2] + 247.6], -1)
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    uv[:40] += rng.uniform(-40, 40, (40, 2)).astype(np.float32)     # outliers
    inv_s2 = np.ones(N, np.float32)
    valid = rng.random(N) < 0.95
    T0 = np.eye(3, 4, dtype=np.float32)
    rj = jlm.optimize_pose(JCAM, jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv),
                           jnp.asarray(inv_s2), jnp.asarray(valid))
    rt = tlm.optimize_pose(TCAM, t(T0), t(X), t(uv), t(inv_s2), t(valid))
    np.testing.assert_allclose(n(rt.T), np.asarray(rj.T), atol=1e-4)
    np.testing.assert_array_equal(n(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(n(rt.chi2), np.asarray(rj.chi2), rtol=1e-3, atol=1e-3)


def test_tracking_steps_on_bootstrapped_map():
    tr, frames, _, _ = jax_bootstrap()
    c, f = tr.carry, frames[0]
    m = c.m
    s2 = scale_sigma2(8, 1.2)
    J = dict(pt_pos=m.pt_pos, pt_valid=m.pt_valid)
    T = {k: t(v) for k, v in J.items()}
    fj = (f.kp, f.desc, f.octave, f.angle, f.valid)
    ft = tuple(t(x) for x in fj)

    rj = jtk.track_motion_model(JCAM, m.pt_pos, m.pt_valid, c.T_last, c.last_kp, c.last_desc,
                                c.last_octave, c.last_angle, c.last_valid, c.last_pt, *fj, s2)
    rt = ttk.track_motion_model(TCAM, T["pt_pos"], T["pt_valid"], t(c.T_last), t(c.last_kp),
                                t(c.last_desc), t(c.last_octave), t(c.last_angle),
                                t(c.last_valid), t(c.last_pt), *ft, t(s2))
    assert int(rj.n_matches) > 50
    np.testing.assert_array_equal(n(rt.cur_pt), np.asarray(rj.cur_pt))
    np.testing.assert_allclose(n(rt.T), np.asarray(rj.T), atol=1e-4)
    assert int(rt.n_inliers) == int(rj.n_inliers)

    ref = int(c.kf_count) - 1
    rj2 = jtk.track_reference_kf(JCAM, m.pt_pos, m.pt_valid, c.T_last, m.kf_desc[ref],
                                 m.kf_kp_valid[ref], m.kf_pt_idx[ref], f.kp, f.desc, f.octave,
                                 f.valid, s2)
    rt2 = ttk.track_reference_kf(TCAM, T["pt_pos"], T["pt_valid"], t(c.T_last), t(m.kf_desc[ref]),
                                 t(m.kf_kp_valid[ref]), t(m.kf_pt_idx[ref]), ft[0], ft[1], ft[2],
                                 ft[4], t(s2))
    np.testing.assert_array_equal(n(rt2.cur_pt), np.asarray(rj2.cur_pt))
    np.testing.assert_allclose(n(rt2.T), np.asarray(rj2.T), atol=1e-4)

    rj3 = jtk.track_local_map_step(JCAM, m.pt_pos, m.pt_valid, m.pt_desc, m.pt_normal,
                                   m.pt_min_dist, m.pt_max_dist, rj.T, rj.cur_pt, f.kp, f.desc,
                                   f.octave, f.valid, s2)
    rt3 = ttk.track_local_map_step(TCAM, T["pt_pos"], T["pt_valid"], t(m.pt_desc), t(m.pt_normal),
                                   t(m.pt_min_dist), t(m.pt_max_dist), t(rj.T), t(rj.cur_pt),
                                   ft[0], ft[1], ft[2], ft[4], t(s2))
    np.testing.assert_array_equal(n(rt3.cur_pt), np.asarray(rj3.cur_pt))
    np.testing.assert_allclose(n(rt3.T), np.asarray(rj3.T), atol=1e-4)

    f0 = frames[1]
    mj = jtk.match_for_init(f.kp, f.desc, f.angle, f.valid, f0.kp, f0.desc, f0.angle, f0.valid)
    mt = ttk.match_for_init(*[t(x) for x in (f.kp, f.desc, f.angle, f.valid,
                                             f0.kp, f0.desc, f0.angle, f0.valid)])
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    cam = JCAM
    vj = jtk.count_visible(m.pt_pos, m.pt_valid, c.T_last, cam.fx, cam.fy, cam.cx, cam.cy,
                           cam.width, cam.height)
    vt = ttk.count_visible(T["pt_pos"], T["pt_valid"], t(c.T_last), cam.fx, cam.fy, cam.cx,
                           cam.cy, cam.width, cam.height)
    assert int(vt) == int(vj)


def test_recorded_motion_model_lm_parts_at_a_chi2_threshold():
    """The first tracking step where the two packages' decisions part, from
    one state, on the interactive bench arc (RANSAC seed 4, frame 100):
    the motion model's matches are equal, and the pose LM on them
    (``tests/pose_lm_seed4_frame100.npz``: its pose prior, 356 matches)
    keeps 339 inliers in both, but two of them differ and the poses lie
    4.7e-4 apart. The cause is float32 rounding at a threshold, not a
    formulation: after the second round the poses differ by 1e-6, and one
    observation's chi2 reads 5.99213 in the reference and 5.99061 in the
    port, either side of 5.991, so the third round runs on other inlier
    sets. Taken in float64, the port lands within 1e-6 of the reference
    (measured 4.4e-8), as does the reference run eagerly (3e-8). Pinned:
    no stage is repaired."""
    import jax

    f = np.load(__file__.rsplit("/", 1)[0] + "/pose_lm_seed4_frame100.npz")
    args = [f[k] for k in ("T0", "Xw", "uv", "inv_sigma2", "valid")]
    rj = jlm.optimize_pose(JCAM, *(jnp.asarray(a) for a in args))
    rt = tlm.optimize_pose(TCAM, *(t(a) for a in args))
    r64 = tlm.optimize_pose(TCAM, *(t(a.astype(np.float64) if a.dtype == np.float32 else a)
                                    for a in args))
    with jax.disable_jit():
        eager = jlm.optimize_pose(JCAM, *(jnp.asarray(a) for a in args))
    assert int(rj.n_inliers) == int(rt.n_inliers) == 339
    assert int((np.asarray(rj.inliers) != n(rt.inliers)).sum()) == 2
    assert np.abs(n(rt.T) - np.asarray(rj.T)).max() > 1e-4          # measured 4.7e-4
    np.testing.assert_allclose(n(r64.T), np.asarray(rj.T), atol=1e-6)
    np.testing.assert_array_equal(n(r64.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(np.asarray(eager.T), np.asarray(rj.T), atol=1e-6)
    # after two rounds the poses agree to float32 noise, and one
    # observation's chi2 straddles the threshold
    sj = jlm.optimize_pose(JCAM, *(jnp.asarray(a) for a in args), schedule=(4, 3))
    st = tlm.optimize_pose(TCAM, *(t(a) for a in args), schedule=(4, 3))
    assert np.abs(n(st.T) - np.asarray(sj.T)).max() < 2e-6             # measured 1.0e-6
    parted = np.flatnonzero(np.asarray(sj.inliers) != n(st.inliers))
    assert len(parted) == 1
    c_ref, c_port = float(np.asarray(sj.chi2)[parted[0]]), float(n(st.chi2)[parted[0]])
    assert abs(c_ref - jlm.CHI2_MONO) < 2e-3 and abs(c_port - jlm.CHI2_MONO) < 2e-3
    assert (c_ref < jlm.CHI2_MONO) != (c_port < jlm.CHI2_MONO)
