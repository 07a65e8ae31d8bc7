"""Parity of local mapping (triangulation, fusion, the bootstrap's
two-keyframe BA) with eao_slam_tpu.runtime.local_mapping.

The inputs are the reference's bootstrapped map and the reference front
end's next frame, tracked by the reference. Matching is integer work and
compares exactly (the neighbour index per feature, the triangulation
gate, the fused point per feature). Triangulated points come from a
float32 SVD in another order: 1e-3 of the scene depth on points whose
parallax passes the gate. The BA agrees as in test_torch_ba.py. The
duplicate merge (exact rows and validity) and the descriptor refresh
(descriptors bit for bit) run on constructed inputs."""

import jax.numpy as jnp
import numpy as np

from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.ops.orb import scale_sigma2
from eao_slam_tpu.runtime import local_mapping as jlm, tracking_kernels as jtk
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.convert import map_state_from_numpy
from eao_slam_torch.runtime import local_mapping as tlm
from torch_parity import (desc_bits_differ, flip_bits, jax_bootstrap, jax_carry_numpy, n,
                          random_descriptors, t)


def _tracked_frame():
    """The first frame after the bootstrap, tracked by the reference against
    its map: (tracker, frame, pose, feature -> point row, sigma^2)."""
    tr, frames, _, _ = jax_bootstrap()
    c, m, f = tr.carry, tr.carry.m, frames[0]
    s2 = scale_sigma2(8, 1.2)
    r1 = jtk.track_motion_model(JCAM, m.pt_pos, m.pt_valid, c.T_last, c.last_kp, c.last_desc,
                                c.last_octave, c.last_angle, c.last_valid, c.last_pt,
                                f.kp, f.desc, f.octave, f.angle, f.valid, s2)
    r2 = jtk.track_local_map_step(JCAM, m.pt_pos, m.pt_valid, m.pt_desc, m.pt_normal,
                                  m.pt_min_dist, m.pt_max_dist, r1.T, r1.cur_pt, f.kp, f.desc,
                                  f.octave, f.valid, s2)
    assert int(r2.n_inliers) > 50
    return tr, f, r2.T, r2.cur_pt, s2


def test_triangulate_with_neighbor_parity():
    tr, f, T, cur_pt, s2 = _tracked_frame()
    m = tr.carry.m
    nb = 0
    args_j = (f.kp, f.desc, f.octave, f.valid, cur_pt,
              m.kf_pose[nb], m.kf_kp[nb], m.kf_desc[nb], m.kf_octave[nb], m.kf_kp_valid[nb],
              m.kf_pt_idx[nb], s2)
    rj = jlm.triangulate_with_neighbor(JCAM, T, *args_j)
    rt = tlm.triangulate_with_neighbor(TCAM, t(T), *[t(a) for a in args_j])
    good = np.asarray(rj.good)
    assert good.sum() > 10
    np.testing.assert_array_equal(n(rt.idx2), np.asarray(rj.idx2))
    np.testing.assert_array_equal(n(rt.good), good)
    depth = np.abs(np.asarray(rj.points)[good]).max()
    np.testing.assert_allclose(n(rt.points)[good], np.asarray(rj.points)[good],
                               atol=1e-3 * depth)


def test_fuse_into_keyframe_parity():
    tr, f, T, cur_pt, s2 = _tracked_frame()
    m = tr.carry.m
    # forget a third of the tracked bindings so fusion has work to do
    cur = np.asarray(cur_pt).copy()
    cur[::3] = -1
    args = (m.pt_pos, m.pt_valid, m.pt_desc, m.pt_min_dist, m.pt_max_dist, T,
            f.kp, f.desc, f.octave, f.valid, cur, s2)
    fj = np.asarray(jlm.fuse_into_keyframe(JCAM, *args))
    ft = n(tlm.fuse_into_keyframe(TCAM, *[t(a) for a in args]))
    assert (fj >= 0).sum() > (cur >= 0).sum()
    np.testing.assert_array_equal(ft, fj)


def test_run_local_ba_bootstrap_window():
    tr = jax_bootstrap()[0]
    m = tr.carry.m
    mt = map_state_from_numpy(jax_carry_numpy(tr.carry)["m"], "cpu")
    s2 = np.asarray(scale_sigma2(8, 1.2))
    rj = jlm.run_local_ba(JCAM, m, [0, 1], [0], s2, 1024)
    rt = tlm.run_local_ba(TCAM, mt, [0, 1], [0], s2, 1024)
    np.testing.assert_array_equal(rt.kf_slots, rj.kf_slots)
    np.testing.assert_array_equal(rt.pt_slots, rj.pt_slots)
    np.testing.assert_allclose(n(rt.poses), rj.poses, atol=1e-3)
    keep = rj.pt_slots >= 0
    np.testing.assert_allclose(n(rt.points)[keep], rj.points[keep], atol=1e-3 * 5.0)
    np.testing.assert_array_equal(rt.drop_obs, rj.drop_obs)


def test_refresh_point_descriptors_parity():
    """Six keyframes over 100 points, each observation a noisy copy of its
    point's descriptor; some rows bind one point twice (the scatter's last
    write wins in both packages) and the window is padded as the tracker
    pads it. Descriptors equal bit for bit."""
    rng = np.random.default_rng(21)
    K, F, P, W = 6, 64, 100, 8
    base = random_descriptors(rng, P)
    kf_pt = rng.integers(-1, P, (K, F)).astype(np.int32)
    kf_pt[:, 10] = kf_pt[:, 11]                     # duplicate bindings
    kf_desc = np.stack([flip_bits(rng, base[np.clip(r, 0, P - 1)], 0.04) for r in kf_pt])
    kf_valid = rng.random((K, F)) < 0.9
    pt_desc = flip_bits(rng, base, 0.2)
    win = np.array([0, 1, 2, 3, 4, 5, 0, 0], np.int32)
    win_valid = np.arange(W) < K
    want = np.asarray(jlm.refresh_point_descriptors(kf_pt, kf_desc, kf_valid, pt_desc, win,
                                                    win_valid, n_win=W))
    got = n(tlm.refresh_point_descriptors(t(kf_pt), t(kf_desc), t(kf_valid), t(pt_desc),
                                          t(win).long(), t(win_valid)))
    assert desc_bits_differ(want, pt_desc) > 0
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_merge_duplicate_points_parity():
    """The bootstrap map with 40 of the tracked frame's points duplicated
    1 mm away (same descriptor, unbound in the frame); the first 10
    duplicates take over the keyframes' observations of their originals,
    so both winner directions occur. Rows and validity exact."""
    tr, f, T, cur_pt, s2 = _tracked_frame()
    d = {k: np.array(v) for k, v in jax_carry_numpy(tr.carry)["m"].items()}
    cur = np.asarray(cur_pt)
    ids = cur[cur >= 0][:40]
    dup = int(d["pt_valid"].sum()) + np.arange(40)
    rng = np.random.default_rng(4)
    for k in ("pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist", "pt_valid"):
        d[k][dup] = d[k][ids]
    d["pt_pos"][dup] = d["pt_pos"][ids] + rng.normal(0, 1e-3, (40, 3)).astype(np.float32)
    kf_pt = d["kf_pt_idx"]
    for a, b in zip(ids[:10], dup[:10]):
        kf_pt[kf_pt == a] = b
    args = (d["pt_pos"], d["pt_valid"], d["pt_desc"], d["pt_min_dist"], d["pt_max_dist"], kf_pt,
            T, f.kp, f.desc, f.octave, f.valid, cur, s2)
    jk, jv = jlm.merge_duplicate_points(JCAM, *[jnp.asarray(a) for a in args])
    tk_, tv = tlm.merge_duplicate_points(TCAM, *[t(a) for a in args])
    jv = np.asarray(jv)
    assert (~jv[dup]).sum() + (~jv[ids]).sum() >= 20      # merges in both directions
    assert (~jv[ids[:10]]).any() and (~jv[dup[10:]]).any()
    np.testing.assert_array_equal(n(tk_), np.asarray(jk))
    np.testing.assert_array_equal(n(tv), jv)


def test_recorded_triangulation_parts_only_at_degenerate_points():
    """A keyframe triangulation of the interactive tracker on the bench arc
    (RANSAC seed 6, frame 96: the new keyframe and a neighbour,
    ``tests/triangulation_seed6_frame96.npz``), the same inputs through both
    packages. The epipolar matches are equal; the accepted points differ on
    3 features, and each of those points lies within 0.01 map units of a
    camera (depth 0.0002-0.009; the scene lies near depth 1). There the DLT's
    4x4 normal matrix is near-degenerate (a camera centre zeroes that
    camera's two rows), so the two packages' float32 eigensolvers land up to
    4e-3 apart and the reprojection gate parts them. Every other decision
    agrees. Pinned: the port triangulates as the reference does; neither
    rejects points at a camera centre, and a gate the reference lacks would
    be a change of behaviour, not a repair."""
    import os

    import jax.numpy as jnp

    f = np.load(os.path.join(os.path.dirname(__file__), "triangulation_seed6_frame96.npz"))
    names = ("T1", "kp1", "desc1", "oct1", "valid1", "pt1",
             "T2", "kp2", "desc2", "oct2", "valid2", "pt2", "scale2")
    rj = jlm.triangulate_with_neighbor(JCAM, *(jnp.asarray(f[k]) for k in names))
    rt = tlm.triangulate_with_neighbor(
        TCAM, *(t(f[k].view(np.int32) if f[k].dtype == np.uint32 else f[k]) for k in names))
    gj, gt = np.asarray(rj.good), n(rt.good)
    np.testing.assert_array_equal(n(rt.idx2), np.asarray(rj.idx2))
    parted = np.flatnonzero(gj != gt)
    assert len(parted) == 3 and gj.sum() > 20
    for X in (np.asarray(rj.points)[parted], n(rt.points)[parted]):
        depth = np.minimum((X @ f["T1"][:, :3].T + f["T1"][:, 3])[:, 2],
                           (X @ f["T2"][:, :3].T + f["T2"][:, 3])[:, 2])
        assert (np.abs(depth) < 0.01).all()
    both = gj & gt
    np.testing.assert_allclose(n(rt.points)[both], np.asarray(rj.points)[both], atol=1e-3)
