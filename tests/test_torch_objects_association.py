"""The object layer's stages in the port against the reference package:
``compute_detection_stats``, ``resolve_cascade`` (the five object-layer
flags without lines), ``apply_frame_update`` (both ``run_iforest``
settings), ``chunk_iforest_cull`` and ``run_merge_pass``.

Inputs: the reference's object stages replayed along a feature-level
sequence (``torch_objects.object_replay``: ground-truth poses, features
bound to their landmarks, three objects, a box dropped every fifth frame
so that the later cascade stages decide, a fourth object created late and
deleted by the merge pass), the reference's state at each frame handed to
the port; random score matrices for the cascade; and constructed
two-object maps for the merge pass's five overlap cases.

Tolerances: integers, masks and point membership exact; floats 1e-4. Two
kinds of float are held through what they are made of, because they
amplify float32 rounding: the t statistics (a centroid difference over a
spread that may be ~1e-9) are held as numerator, |c_det - c_obj|, to
1e-4 m; ``std`` and ``center_std`` (square roots of E[x^2] - E[x]^2,
where the two nearly cancel: objects 4 m away with a spread of 4 cm) as
variances, to 16 float32 ulps of E[x^2]: the sums of a few hundred
members in another order differ by up to 6.4 ulps here. The iForest takes the reference's draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eao_slam_tpu.geometry.camera import TUM3 as JCAM
from eao_slam_tpu.objects import association as ja, merge as jm, resolve as jr
from eao_slam_torch.config import DemoFlag
from eao_slam_torch.geometry.camera import TUM3 as TCAM
from eao_slam_torch.objects import association as ta, merge as tm, resolve as tr
from eao_slam_torch.objects.iforest import psi_depth_for
from eao_slam_torch.objects.stats import make_t_table
from torch_objects import (draws_from, jax_map, jax_table, object_replay, object_sequence,
                           table_numpy, torch_map, torch_table)
from torch_parity import n, t

PSI, DEPTH = psi_depth_for(ta.N_OBJ_SAMPLE)
T_TABLE = torch.as_tensor(make_t_table())
VARIANCE_FIELDS = ("std", "center_std")


def assert_table_equal(got: dict, want: dict, tag: str):
    for f, w in want.items():
        g = got[f]
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{tag}: {f}")
        elif f in VARIANCE_FIELDS:
            mean = want["center"] if f == "std" else want["cent_sum"] / np.maximum(
                want["n_obs"], 1)[:, None]
            second_moment = mean.astype(np.float64) ** 2 + w.astype(np.float64) ** 2
            floor = 16 * np.finfo(np.float32).eps * second_moment
            assert (np.abs(g.astype(np.float64) ** 2 - w.astype(np.float64) ** 2)
                    <= floor + 1e-12).all(), f"{tag}: {f}"
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=f"{tag}: {f}")


def _frame_inputs(f):
    return (t(f["T"][:3]), t(f["kp"]), t(f["cur_pt"]).int(), t(f["boxes"]), t(f["cls"]).int(),
            t(f["score"]), t(f["bvalid"]))


def test_detection_stats_along_the_replay():
    R = object_replay()
    frames = object_sequence()[3]
    for k, rec in enumerate(R["frames"]):
        T, kp, cur_pt, bxs, cls, score, bvalid = _frame_inputs(frames[k])
        m = torch_map(rec["pt_object_id"], rec["pt_obj_votes"])
        table = torch_table(rec["table"])
        det = ta.compute_detection_stats(TCAM, m.pt_pos, m.pt_valid, m.pt_object_id, table, T,
                                         kp, cur_pt, bxs, cls, score, bvalid, rec["frame_id"])
        want = rec["det"]
        for f in det._fields:
            g, w = n(getattr(det, f)), want[f]
            if f == "t_vals":
                denom = np.maximum(rec["table"]["center_std"] / np.sqrt(np.maximum(
                    rec["table"]["n_obs"], 1))[:, None], 1e-9)[None]
                np.testing.assert_allclose(g * denom, w * denom, atol=1e-4, err_msg=f"{k}: {f}")
            elif w.dtype == bool or np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w, err_msg=f"frame {k}: {f}")
            else:
                np.testing.assert_allclose(g, w, atol=1e-4, err_msg=f"frame {k}: {f}")


def _random_detections(rng, B, J):
    """Score matrices that reach every stage: valid objects with n_obs
    around the stage-3 / stage-4 gates (8), IoUs around 0.5 / 0.6,
    projected IoUs around 0.25, t values around the critical values,
    sanity flags on and off, and boxes on and off the 10-pixel border."""
    f32 = np.float32
    det = dict(
        det_valid=rng.random(B) < 0.85,
        det_center=rng.normal(0, 1, (B, 3)).astype(f32),
        det_npts=rng.integers(0, 25, B).astype(np.int32),
        det_pt_mask=np.zeros((B, 4), bool),
        feat_rect=np.zeros((B, 4), f32),
        iou_pred=(rng.random((B, J)) * (rng.random((B, J)) < 0.3)).astype(f32),
        iou_thresh=np.where(rng.random(J) < 0.5, 0.6, 0.5).astype(f32),
        np_pass=rng.random((B, J)) < 0.3,
        np_m_ok=rng.random(B) < 0.7,
        np_n_ok=rng.random(J) < 0.7,
        proj_iou=(rng.random((B, J)) * 0.6).astype(f32),
        t_vals=rng.uniform(0, 6, (B, J, 3)).astype(f32),
        sanity_iou=rng.random((B, J)).astype(f32),
        sanity_former=rng.random((B, J)).astype(f32),
        class_ok=rng.random((B, J)) < 0.6,
        obj_sub_idx=np.zeros((J, 4), np.int32),
        obj_sub_mask=np.zeros((J, 4), bool),
    )
    tab = table_numpy(torch_table_empty(J))
    tab["valid"] = rng.random(J) < 0.7
    tab["bad"] = rng.random(J) < 0.1
    tab["n_obs"] = rng.integers(5, 13, J).astype(np.int32)
    x = rng.choice([2.0, 50.0, 300.0], B)
    y = rng.choice([3.0, 40.0, 200.0], B)
    w = rng.choice([40.0, 200.0, 330.0], B)
    bxs = np.stack([x, y, w, np.full(B, 100.0)], 1).astype(f32)
    return det, tab, bxs


def torch_table_empty(J):
    from eao_slam_torch.objects.state import empty_object_table

    return empty_object_table(J)


@pytest.mark.parametrize("flag", ["EAO", "iForest", "NA", "IoU", "NP"])
def test_resolve_cascade_for_each_flag(flag):
    """assoc, new_slots and re_inc exact, on 40 random score matrices that
    reach every stage and the border rule, and (EAO) along the replay."""
    f = DemoFlag(flag)
    stages = dict(use_iou=f.use_iou, use_nonparam=f.use_nonparam, use_ttest=f.use_ttest)
    jt = jnp.asarray(T_TABLE.numpy())
    rng = np.random.default_rng(len(flag))
    reached = np.zeros(4, int)
    for trial in range(40):
        det, tab, bxs = _random_detections(rng, 8, 16)
        got = tr.resolve_cascade(ta.FrameDetections(**{k: t(v) for k, v in det.items()}),
                                 torch_table(tab), T_TABLE, t(bxs), 0.25, **stages)
        want = jr.resolve_cascade(ja.FrameDetections(**{k: jnp.asarray(v) for k, v in det.items()}),
                                  jax_table(tab), jt, jnp.asarray(bxs), 0.25, **stages)
        for k in got._fields:
            np.testing.assert_array_equal(n(getattr(got, k)), np.asarray(getattr(want, k)),
                                          err_msg=f"{flag} trial {trial}: {k}")
        a = np.asarray(want.assoc)
        reached += [(a >= 0).sum(), (np.asarray(want.new_slots) >= 0).sum(),
                    int(np.asarray(want.re_inc).sum()),
                    ((a < 0) & det["det_valid"] & (np.asarray(want.new_slots) < 0)).sum()]
    assert reached[1] > 0 and reached[3] > 0         # new objects, and border / too-few refusals
    if flag != "NA":
        assert reached[0] > 0                        # associations
    if flag in ("EAO", "iForest", "NP"):
        assert reached[2] > 0                        # potential-association votes
    if flag == "EAO":
        frames = object_sequence()[3]
        for k, rec in enumerate(object_replay()["frames"]):
            det = ta.FrameDetections(**{k2: t(v) for k2, v in rec["det"].items()})
            got = tr.resolve_cascade(det, torch_table(rec["table"]), T_TABLE,
                                     t(frames[k]["boxes"]), 0.25, **stages)
            for k2 in got._fields:
                np.testing.assert_array_equal(n(getattr(got, k2)), rec["res"][k2],
                                              err_msg=f"frame {k}: {k2}")


def _apply(rec, frame, draw=None, run_iforest=False):
    T, kp, cur_pt, bxs, cls, _, _ = _frame_inputs(frame)
    det = ta.FrameDetections(**{k: t(v) for k, v in rec["det"].items()})
    m, table = ta.apply_frame_update(
        TCAM, torch_map(rec["pt_object_id"], rec["pt_obj_votes"]), torch_table(rec["table"]),
        det, t(rec["res"]["assoc"]).int(), t(rec["res"]["new_slots"]).int(), bxs, cls, T, kp,
        cur_pt, rec["frame_id"], draw=draw, depth=DEPTH, run_iforest=run_iforest)
    return m, table._replace(re_obj=table.re_obj + t(rec["res"]["re_inc"]))


def test_apply_frame_update_along_the_replay():
    """run_iforest=False (the chunked tracker's setting) on every frame:
    point membership, votes and the whole table."""
    frames = object_sequence()[3]
    for k, rec in enumerate(object_replay()["frames"]):
        m, table = _apply(rec, frames[k])
        np.testing.assert_array_equal(n(m.pt_object_id), rec["pt_object_id_after"], str(k))
        np.testing.assert_array_equal(n(m.pt_obj_votes), rec["pt_obj_votes_after"], str(k))
        assert_table_equal(table_numpy(table), rec["table_after"], f"frame {k}")


def test_apply_frame_update_with_the_per_frame_iforest():
    """run_iforest=True (the C++ reference's pacing) on frames whose objects
    have enough members for the forest to run, with the reference's draws
    from the frame's key: an outlier eviction happens and matches."""
    frames = object_sequence()[3]
    recs = object_replay()["frames"]
    evicted = 0
    for k in (20, 33):
        rec, f = recs[k], frames[k]
        jm_, jt_ = ja.apply_frame_update(
            JCAM, jax_map(rec["pt_object_id"], rec["pt_obj_votes"]), jax_table(rec["table"]),
            ja.FrameDetections(**{k2: jnp.asarray(v) for k2, v in rec["det"].items()}),
            jnp.asarray(rec["res"]["assoc"]), jnp.asarray(rec["res"]["new_slots"]),
            jnp.asarray(f["boxes"]), jnp.asarray(f["cls"]), jnp.asarray(f["T"][:3]),
            jnp.asarray(f["kp"]), jnp.asarray(f["cur_pt"]), jnp.int32(rec["frame_id"]),
            jnp.asarray(rec["frame_key"]), psi=PSI, depth=DEPTH, run_iforest=True)
        jt_ = jt_._replace(re_obj=jt_.re_obj + jnp.asarray(rec["res"]["re_inc"]))
        m, table = _apply(rec, f, draws_from(jnp.asarray(rec["frame_key"]), PSI, DEPTH), True)
        np.testing.assert_array_equal(n(m.pt_object_id), np.asarray(jm_.pt_object_id))
        np.testing.assert_array_equal(n(m.pt_obj_votes), np.asarray(jm_.pt_obj_votes))
        assert_table_equal(table_numpy(table), table_numpy(jt_), f"frame {k}")
        evicted += int((np.asarray(jm_.pt_object_id) != rec["pt_object_id_after"]).sum())
    assert evicted > 0


def test_chunk_iforest_cull_along_the_replay():
    culled = 0
    for c in object_replay()["culls"]:
        m, table = ta.chunk_iforest_cull(
            TCAM, torch_map(c["pt_object_id"], c["pt_obj_votes"]), torch_table(c["table"]),
            t(c["T"]), int(c["since"]), draws_from(jnp.asarray(c["key"]), PSI, DEPTH), DEPTH)
        np.testing.assert_array_equal(n(m.pt_object_id), c["pt_object_id_after"])
        np.testing.assert_array_equal(n(m.pt_obj_votes), c["pt_obj_votes_after"])
        assert_table_equal(table_numpy(table), c["table_after"], "cull")
        culled += int((c["pt_object_id"] != c["pt_object_id_after"]).sum())
    assert culled > 0


def test_merge_pass_along_the_replay():
    """On the replay the pass decides nothing (the cases below do): the
    port decides nothing either and hands back its inputs."""
    for c in object_replay()["merges"]:
        m0 = torch_map(c["pt_object_id"], c["pt_obj_votes"])
        t0 = torch_table(c["table"])
        m, table, merged, killed = tm.run_merge_pass(m0, t0)
        np.testing.assert_array_equal(n(m.pt_object_id), c["pt_object_id_after"])
        assert_table_equal(table_numpy(table), c["table_after"], "merge")
        assert (m, table, merged, killed) == (m0, t0, 0, 0)


def _two_objects(seed, half=(0.4, 0.4), offset=(0.1, 0.0, 0.0), cls=(56, 56), n_obs=(12, 12),
                 co=0, re=0, n_pts=40):
    """Two objects of ``n_pts`` points each (std 0.15 m) around centres 4 m
    ahead, ``offset`` apart, with cuboid half-sizes ``half`` (the reference
    package's tests/test_object_merge.py construction)."""
    rng = np.random.default_rng(seed)
    P, J = 1024, 8
    c1 = np.array([0.0, 0.0, 4.0], np.float32)
    c2 = c1 + np.asarray(offset, np.float32)
    pos = np.zeros((P, 3), np.float32)
    pos[:2 * n_pts] = np.concatenate([c1 + rng.normal(0, 0.15, (n_pts, 3)),
                                      c2 + rng.normal(0, 0.15, (n_pts, 3))])
    live = np.arange(P) < 2 * n_pts
    pts = dict(pt_pos=pos, pt_valid=live,
               pt_object_id=np.where(live, np.arange(P) // n_pts, -1).astype(np.int32),
               pt_obj_votes=np.where(live, 3, 0).astype(np.int32))
    tab = table_numpy(torch_table_empty(J))
    for j, c in enumerate((c1, c2)):
        tab["valid"][j] = True
        tab["cls"][j] = cls[j]
        tab["n_obs"][j] = n_obs[j]
        tab["last_frame"][j] = 20
        tab["center"][j] = c
        tab["center_std"][j] = 0.1
        tab["cent_sum"][j] = c * n_obs[j]
        tab["cent_sumsq"][j] = (c ** 2 + 0.01) * n_obs[j]
        tab["cub_min"][j] = -half[j]
        tab["cub_max"][j] = half[j]
        tab["r_max"][j] = 0.7
    tab["co_occur"][0, 1] = tab["co_occur"][1, 0] = co
    tab["re_obj"][0, 1] = re
    return pts, tab


# DealTwoOverlapObjs' five cases and the potential-association merge. Case
# 5's condition (IoU, never together, same class) is always taken by case 1
# (similar volumes) or case 2 (one volume over twice the other) first, in
# the reference package as in the port; its inputs run all the same.
MERGE_CASES = {
    "potential association": dict(offset=(0.05, 0, 0), re=5),
    "1 merge": dict(),
    "2 delete the smaller": dict(half=(0.6, 0.25), n_obs=(14, 12)),
    "2 delete the first": dict(half=(0.25, 0.6), n_obs=(10, 12)),
    "3 divide": dict(offset=(0.15, 0.15, 0.15), co=10, n_pts=400),
    "4 big to small": dict(half=(0.8, 0.2), cls=(56, 62), co=10),
    "5 (taken by 1)": dict(offset=(0.2, 0, 0), n_obs=(30, 12)),
    "apart": dict(offset=(3.0, 0, 0)),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_pass_cases(case):
    from eao_slam_tpu.runtime.map_state import empty_map_state as jempty
    from eao_slam_tpu.config import CapacityConfig as JCap
    from eao_slam_torch.config import CapacityConfig as TCap
    from eao_slam_torch.runtime.map_state import empty_map_state as tempty

    pts, tab = _two_objects(0, **MERGE_CASES[case])
    mj = jempty(JCap(max_keyframes=2, max_points=1024, max_features=8))._replace(
        **{k: jnp.asarray(v) for k, v in pts.items()})
    mt = tempty(TCap(max_keyframes=2, max_points=1024, max_features=8), "cpu")._replace(
        **{k: t(v) for k, v in pts.items()})
    mj2, tj2 = jm.run_merge_pass(mj, jax_table(tab))
    mt2, tt2, merged, killed = tm.run_merge_pass(mt, torch_table(tab))
    np.testing.assert_array_equal(n(mt2.pt_object_id), np.asarray(mj2.pt_object_id))
    np.testing.assert_array_equal(n(mt2.pt_obj_votes), np.asarray(mj2.pt_obj_votes))
    assert_table_equal(table_numpy(tt2), table_numpy(tj2), case)
    live = tab["valid"] & ~tab["bad"]
    live2 = n(tt2.valid) & ~n(tt2.bad)
    expect_live = {"potential association": 1, "1 merge": 1, "2 delete the smaller": 1,
                   "2 delete the first": 1, "5 (taken by 1)": 1}.get(case, 2)
    assert live2.sum() == expect_live, (case, live.sum(), live2.sum())
    assert merged + killed == 2 - expect_live
    if case in ("3 divide", "4 big to small"):
        assert (n(mt2.pt_object_id) != pts["pt_object_id"]).any()
