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


# A point's Hessian block from the interactive tracker's windowed BA on the
# bench arc (seed 1, the keyframe of frame 23): a point close to a camera.
NEAR_CAMERA_HPP = np.array([[11205657755648.0, -475687649280.0, 6978280620032.0],
                            [-475687649280.0, 12205837778944.0, 4591358312448.0],
                            [6978280620032.0, 4591358312448.0, 6312119762944.0]], np.float32)


def test_inv3x3_of_a_block_whose_adjugate_terms_overflow_float32():
    """The determinant of NEAR_CAMERA_HPP fits in float32 (8.2e35), but its
    terms a * A11 do not (about 6e38): taken one by one in float32, as
    eager torch takes them, they give inf - inf, and the port's inverse was
    NaN. The reference's jitted float32 gets an infinite determinant and so
    a zero inverse (the point is frozen); the port now gives that zero block
    too, and other blocks exactly as before (a well-conditioned one to
    float32 rounding of numpy's inverse)."""
    import jax

    A = NEAR_CAMERA_HPP
    a, b, c, d, e, f, g, h, i = (np.float32(x) for x in A.ravel())
    with np.errstate(over="ignore", invalid="ignore"):
        det32 = a * (e * i - f * h) + b * (f * g - d * i) + c * (d * h - e * g)
    assert not np.isfinite(det32)                  # the float32 terms overflow
    assert np.isfinite(np.linalg.det(A.astype(np.float64)))
    B = np.array([[4.0, 1.0, 0.5], [1.0, 3.0, 0.2], [0.5, 0.2, 2.0]], np.float32) * 1e6
    blocks = np.stack([A, B])
    got = n(tba.inv3x3(t(blocks)))
    ref = np.asarray(jax.jit(jba.inv3x3)(jnp.asarray(blocks)))
    np.testing.assert_array_equal(ref[0], np.zeros((3, 3), np.float32))
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], np.linalg.inv(B.astype(np.float64)), rtol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)


def _recorded_window_map():
    """``tests/ba_near_camera_point.npz`` (the interactive tracker's map at
    the keyframe of frame 23 on the bench arc, seed 1: eight keyframes and
    their 1088 points): the file, the MapState fields it sets, and the
    capacity that holds them."""
    import os

    f = np.load(os.path.join(os.path.dirname(__file__), "ba_near_camera_point.npz"))
    K, F = f["kf_pt_idx"].shape
    P = len(f["pt_pos"])
    fields = dict(kf_pose=f["kf_pose"], kf_kp=f["kf_kp"], kf_octave=f["kf_octave"].astype(np.int32),
                  kf_kp_valid=f["kf_kp_valid"], kf_pt_idx=f["kf_pt_idx"].astype(np.int32),
                  kf_valid=np.ones(K, bool), pt_pos=f["pt_pos"], pt_valid=np.ones(P, bool))
    return f, fields, dict(max_keyframes=K, max_points=P, max_features=F, local_ba_points=2048)


def test_windowed_ba_with_a_point_at_a_camera():
    """A real window: the interactive tracker's windowed BA at the keyframe
    of frame 23 on the bench arc, seed 1 (the reference's map, its eight
    keyframes and their 1088 points, ``tests/ba_near_camera_point.npz``).
    NEAR_CAMERA_HPP is one of its point blocks. It made every LM step of the
    port non-finite: the port's BA moved nothing and dropped 12 observations
    where the reference's drops 3, and runs of the interactive tracker kept
    sparser maps. Now both freeze that point, drop the same observations
    and agree on the poses to 1e-4 (measured 7e-7 after 5 iterations)."""
    from eao_slam_torch.config import CapacityConfig as TC
    from eao_slam_torch.runtime import local_mapping as tlm
    from eao_slam_torch.runtime.map_state import empty_map_state as t_empty
    from eao_slam_tpu.config import CapacityConfig as JC
    from eao_slam_tpu.runtime import local_mapping as jlm
    from eao_slam_tpu.runtime.map_state import empty_map_state as j_empty

    f, fields, cap = _recorded_window_map()
    K = cap["max_keyframes"]
    jm = j_empty(JC(**cap))._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    tm = t_empty(TC(**cap), "cpu")._replace(**{k: t(v) for k, v in fields.items()})
    window, fixed = list(range(K)), [int(x) for x in f["fixed"]]
    rj = jlm.run_local_ba(JCAM, jm, window, fixed, f["scale2"], 2048)
    rt = tlm.run_local_ba(TCAM, tm, window, fixed, f["scale2"], 2048)
    assert int(rj.drop_obs.sum()) == 3
    np.testing.assert_array_equal(np.asarray(rt.drop_obs), rj.drop_obs)
    np.testing.assert_allclose(n(rt.poses), np.asarray(rj.poses), atol=1e-4)


def _recorded_window():
    """The BAProblem that the port's run_local_ba builds from the recorded
    window (``_recorded_window_map``) and the same problem for the
    reference."""
    from eao_slam_torch.config import CapacityConfig as TC
    from eao_slam_torch.runtime import local_mapping as tlm
    from eao_slam_torch.runtime.map_state import empty_map_state as t_empty

    f, fields, cap = _recorded_window_map()
    K = cap["max_keyframes"]
    tm = t_empty(TC(**cap), "cpu")._replace(**{k: t(v) for k, v in fields.items()})
    seen = []

    def spy(cam, prob):
        seen.append(prob)
        return tba.local_ba(cam, prob)

    tlm.run_local_ba(TCAM, tm, list(range(K)), [int(x) for x in f["fixed"]], f["scale2"], 2048,
                     solver=spy)
    tprob = seen[0]
    return jba.BAProblem(**{k: jnp.asarray(n(v)) for k, v in tprob._asdict().items()}), tprob


def test_window_assembly_parts_at_the_reference_bf16_split():
    """Where the windowed BA's normal equations part, on a recorded window
    (8 keyframes, 2048 point slots, 8192 observation slots): given the
    reference's own per-observation terms, the port's float64 sum of the
    exact float32 terms lies 1e-6 to 3e-5 of each block's largest entry from
    the reference's blocks (measured 1.8e-6 to 1.2e-5): that is the
    reference's one-hot matmul, which splits every term into two bfloat16
    halves (about 16 mantissa bits, 2^-17 = 7.6e-6 of a term). Rounded so
    (``port_ate_spread.ref_round``, what ``--ref-ba-rounding`` feeds the
    port's assembly), the port's sum equals the reference's Hpp, Wcp and
    bp bit for bit, and Hcc and bc within 2e-7 of their largest entry
    (measured 1.1e-7 and 8.8e-8: the reference accumulates hundreds of
    terms a keyframe in float32, the port in float64). Pinned: the port
    keeps its float64 sum of exact terms; with the terms rounded so, its
    interactive ATE spread over 40 seeds does not move (PERF.md)."""
    import jax
    import torch

    from port_ate_spread import ref_round

    jprob, tprob = _recorded_window()

    @jax.jit
    def terms(prob):
        r, Jc, Jp, ok = jba._residuals(JCAM, prob, prob.poses, prob.points)
        w = jba._weights(prob, r, ok)[0]
        wJc, wJp = Jc * w[:, None, None], Jp * w[:, None, None]
        O = r.shape[0]
        return (jnp.einsum("oki,okj->oij", wJc, Jc).reshape(O, 36),
                jnp.einsum("oki,okj->oij", wJp, Jp).reshape(O, 9),
                jnp.einsum("oki,okj->oij", wJc, Jp).reshape(O, 18),
                jnp.einsum("oki,ok->oi", wJc, r), jnp.einsum("oki,ok->oi", wJp, r))

    want = [np.asarray(x) for x in jax.jit(jba._lm_system, static_argnums=0)(
        JCAM, jprob, jprob.poses, jprob.points, jba._build_gather(jprob))[:5]]
    occ, opp, ocp, obc, obp = (torch.as_tensor(np.asarray(x)) for x in terms(jprob))
    K, P = tprob.poses.shape[0], tprob.points.shape[0]
    kf, pt = tprob.kf_idx.long(), tprob.pt_idx.long()

    def blocks(rnd):
        def seg(rows, idx, x):
            x = ref_round(x) if rnd else x
            out = torch.zeros((rows, x.shape[1]), dtype=torch.float64)
            return n(out.index_add_(0, idx, x.double()).float())
        return [seg(K, kf, occ).reshape(K, 6, 6), seg(P, pt, opp).reshape(P, 3, 3),
                seg(K * P, kf * P + pt, ocp).reshape(K, P, 6, 3), seg(K, kf, obc), seg(P, pt, obp)]

    names = ("Hcc", "Hpp", "Wcp", "bc", "bp")
    for name, got, ref in zip(names, blocks(False), want):
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert 1e-6 < rel < 3e-5, (name, rel)
    for name, got, ref in zip(names, blocks(True), want):
        if name in ("Hpp", "Wcp", "bp"):
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            assert np.abs(got - ref).max() <= 2e-7 * np.abs(ref).max(), name
