"""The interactive tracker's per-frame object pipeline (``ObjectUpdater``)
in the port against the reference package's.

- ``resolve`` (the device cascade the port's updater runs) against the
  reference updater's host ``_resolve`` and ``_allocate_slots``, on the
  reference's own detection statistics along
  ``torch_objects.object_sequence`` and on random score matrices that
  reach every stage, for the five object-layer flags without lines:
  associations, new-object slots and the potential-association votes
  (each reference pair one count in ``re_inc``) exact.
- ``frame_update`` along the same sequence, from the reference's state
  before each frame, with the reference's iForest draws injected (its
  updater's key, split once a frame): point membership, votes and the
  appear-new verdict exact, the table to 1e-5 and, for pixel rectangles
  of a few hundred, 1e-6 relative (float32's last bits there), the yaw
  histogram 1e-4 relative (sums of float32 angle differences in another
  order, held to 1e-3 degree in ``test_torch_yaw.py``); its
  square-root spreads as variances, as in
  ``test_torch_objects_association.py``. In line mode
  (``LineAndiForest``) with random segments, so the yaw vote runs.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eao_slam_torch.objects import association as ta
from eao_slam_torch.objects.iforest import psi_depth_for
from eao_slam_torch.objects.state import empty_object_table
from eao_slam_tpu.objects import association as ja
from torch_objects import (IFOREST_SEED, draws_from, jax_map, jax_object_config, jax_table,
                           object_replay, object_sequence, table_numpy, torch_map,
                           torch_object_config, torch_table)
from torch_parity import n, t

PSI, DEPTH = psi_depth_for(ta.N_OBJ_SAMPLE)
N_FRAMES = 24
N_LINES = 32
VARIANCE_FIELDS = ("std", "center_std")


def _random_detections(rng, B, J):
    f32 = np.float32
    det = dict(
        det_valid=rng.random(B) < 0.85, det_center=rng.normal(0, 1, (B, 3)).astype(f32),
        det_npts=rng.integers(0, 40, B).astype(np.int32),
        det_pt_mask=np.zeros((B, 4), bool), feat_rect=np.zeros((B, 4), f32),
        iou_pred=(rng.random((B, J)) * (rng.random((B, J)) < 0.3)).astype(f32),
        iou_thresh=np.where(rng.random(J) < 0.5, 0.6, 0.5).astype(f32),
        np_pass=rng.random((B, J)) < 0.3, np_m_ok=rng.random(B) < 0.7,
        np_n_ok=rng.random(J) < 0.7, proj_iou=(rng.random((B, J)) * 0.6).astype(f32),
        t_vals=rng.uniform(0, 6, (B, J, 3)).astype(f32),
        sanity_iou=rng.random((B, J)).astype(f32), sanity_former=rng.random((B, J)).astype(f32),
        class_ok=rng.random((B, J)) < 0.6, obj_sub_idx=np.zeros((J, 4), np.int32),
        obj_sub_mask=np.zeros((J, 4), bool))
    tab = table_numpy(empty_object_table(J))
    tab["valid"] = rng.random(J) < 0.7
    tab["bad"] = rng.random(J) < 0.1
    tab["n_obs"] = rng.integers(5, 13, J).astype(np.int32)
    x = rng.choice([2.0, 50.0, 300.0], B)
    y = rng.choice([3.0, 40.0, 200.0], B)
    w = rng.choice([40.0, 200.0, 330.0], B)
    bxs = np.stack([x, y, w, np.full(B, 100.0)], 1).astype(f32)
    return det, tab, bxs


def _resolve_both(flag, det, tab, bxs):
    """(assoc, new slots, [J, J] vote increments) of the port's updater and
    of the reference's host cascade on one frame's detections."""
    ju = ja.ObjectUpdater(jax_object_config(flag))
    tu = ta.ObjectUpdater(torch_object_config(flag))
    jtab = jax_table(tab)
    w_assoc, w_new, w_pairs = ju._resolve(
        ja.FrameDetections(**{k: jnp.asarray(v) for k, v in det.items()}), jtab, None,
        jnp.asarray(bxs), 0)
    w_inc = np.zeros((len(tab["valid"]),) * 2, np.int64)
    for src, dst in w_pairs:
        w_inc[src, dst] += 1
    want = (w_assoc, ju._allocate_slots(jtab, w_new), w_inc, len(w_pairs))
    res = tu.resolve(ta.FrameDetections(**{k: t(v) for k, v in det.items()}),
                     torch_table(tab), t(bxs))
    return (n(res.assoc), n(res.new_slots), n(res.re_inc)), want


@pytest.mark.parametrize("flag", ["EAO", "iForest", "NA", "IoU", "NP"])
def test_resolve_exact(flag):
    rng = np.random.default_rng(len(flag) + 100)
    reached = np.zeros(3, int)
    cases = [_random_detections(rng, 8, 16) for _ in range(40)]
    if flag == "EAO":
        frames = object_sequence()[3]
        cases += [(rec["det"], rec["table"], frames[k]["boxes"])
                  for k, rec in enumerate(object_replay()["frames"])]
    for i, (det, tab, bxs) in enumerate(cases):
        (ga, gs, gi), (wa, ws, wi, n_pairs) = _resolve_both(flag, det, tab, bxs)
        np.testing.assert_array_equal(ga, wa, err_msg=f"{flag} case {i}")
        np.testing.assert_array_equal(gs, ws, err_msg=f"{flag} case {i}")
        np.testing.assert_array_equal(gi, wi, err_msg=f"{flag} case {i}")
        reached += [(wa >= 0).sum(), (ws >= 0).sum(), n_pairs]
    assert reached[1] > 0
    if flag != "NA":
        assert reached[0] > 0
    if flag in ("EAO", "iForest", "NP"):
        assert reached[2] > 0


def _lines(k):
    """Random segments of frame k (line mode): 32 slots, 28 valid."""
    rng = np.random.default_rng(1000 + k)
    p = rng.uniform([0, 0], [640, 480], (N_LINES, 2))
    d = rng.normal(0, 40, (N_LINES, 2))
    segs = np.concatenate([p, p + d], 1).astype(np.float32)
    return segs, np.arange(N_LINES) < 28


@lru_cache(maxsize=None)
def reference_updates(flag: str):
    """The reference updater along the first frames of the sequence: per
    frame its key, the state before and after, and the verdict."""
    from eao_slam_tpu.objects.state import empty_object_table as j_empty

    cfg = jax_object_config(flag)
    if flag == "LineAndiForest":
        from eao_slam_tpu.config import CapacityConfig

        cfg = cfg.replace(capacity=CapacityConfig(**{**cfg.capacity.__dict__,
                                                     "max_lines": N_LINES}))
    frames = object_sequence()[3]
    P = object_sequence()[1].shape[0]
    ju = ja.ObjectUpdater(cfg)
    m = jax_map(np.full(P, -1, np.int32), np.zeros(P, np.int32))
    table = j_empty(cfg.capacity.max_objects, cfg.objects.yaw_samples)
    out = []
    for k in range(N_FRAMES):
        f = frames[k]
        key_before = ju._key
        _, k_frame = jax.random.split(key_before)
        rec = {"frame_key": np.asarray(k_frame), "pt_object_id": n(m.pt_object_id),
               "pt_obj_votes": n(m.pt_obj_votes), "table": table_numpy(table)}
        lines = None
        if flag == "LineAndiForest":
            lines = tuple(jnp.asarray(x) for x in _lines(k))
        m, table, appear = ju.frame_update(
            m, table, tuple(jnp.asarray(f[x]) for x in ("boxes", "cls", "score", "bvalid")),
            f["T"][:3], jnp.asarray(f["kp"]), jnp.asarray(f["cur_pt"]), k + 1, lines=lines)
        rec.update(appear=appear, pt_object_id_after=n(m.pt_object_id),
                   pt_obj_votes_after=n(m.pt_obj_votes), table_after=table_numpy(table))
        out.append(rec)
    return out


def assert_table_close(got: dict, want: dict, tag: str):
    for f, w in want.items():
        g = got[f]
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{tag}: {f}")
        elif f in VARIANCE_FIELDS:
            mean = want["center"] if f == "std" else want["cent_sum"] / np.maximum(
                want["n_obs"], 1)[:, None]
            floor = 16 * np.finfo(np.float32).eps * (mean.astype(np.float64) ** 2
                                                     + w.astype(np.float64) ** 2)
            assert (np.abs(g.astype(np.float64) ** 2 - w.astype(np.float64) ** 2)
                    <= floor + 1e-12).all(), f"{tag}: {f}"
        elif f == "yaw_hist":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4, err_msg=f"{tag}: {f}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-6, err_msg=f"{tag}: {f}")


@pytest.mark.parametrize("flag", ["EAO", "LineAndiForest"])
def test_frame_update_with_reference_draws(flag):
    frames = object_sequence()[3]
    cfg = torch_object_config(flag)
    if flag == "LineAndiForest":
        from eao_slam_torch.config import CapacityConfig

        cfg = cfg.replace(capacity=CapacityConfig(**{**cfg.capacity.__dict__,
                                                     "max_lines": N_LINES}))
    tu = ta.ObjectUpdater(cfg)
    assert (tu.psi, tu.depth) == (PSI, DEPTH)
    assert cfg.objects.iforest_seed == IFOREST_SEED
    voted = appeared = 0
    for k, rec in enumerate(reference_updates(flag)):
        f = frames[k]
        tu.draw = draws_from(jnp.asarray(rec["frame_key"]), PSI, DEPTH)
        lines = tuple(t(x) for x in _lines(k)) if flag == "LineAndiForest" else None
        m, table, appear = tu.frame_update(
            torch_map(rec["pt_object_id"], rec["pt_obj_votes"]), torch_table(rec["table"]),
            (t(f["boxes"]), t(f["cls"]).int(), t(f["score"]), t(f["bvalid"])), f["T"][:3],
            t(f["kp"]), t(f["cur_pt"]).int(), k + 1, lines=lines)
        assert appear == rec["appear"], k
        np.testing.assert_array_equal(n(m.pt_object_id), rec["pt_object_id_after"], str(k))
        np.testing.assert_array_equal(n(m.pt_obj_votes), rec["pt_obj_votes_after"], str(k))
        assert_table_close(table_numpy(table), rec["table_after"], f"{flag} frame {k}")
        appeared += appear
        voted += int((rec["table_after"]["yaw_hist"] != rec["table"]["yaw_hist"]).any())
    assert appeared >= 1 and rec["table_after"]["valid"].sum() >= 3
    if flag == "LineAndiForest":
        assert voted > 0


def _chunked_eao(cfg, n_chunks):
    """A port ChunkedTracker in EAO mode on ``feature_sequence`` with its
    projected boxes (chunk 8), bootstrapped and run ``n_chunks`` chunks."""
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import make_room_scene, project_boxes
    from eao_slam_torch.runtime import scan_tracker as tst
    from eao_slam_torch.runtime.frame import frame_from_arrays
    from torch_parity import feature_sequence

    ts, gt, obs = feature_sequence()
    scene = make_room_scene(seed=3, n_landmarks=1200, n_objects=3)

    def frame(k):
        o = obs[k]
        return frame_from_arrays(cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                 valid=o["valid"], boxes=project_boxes(scene, TUM3, gt[k], 8))

    tt = tst.ChunkedTracker(cfg, chunk=8, device="cpu")
    i = 0
    while not tt.armed:
        tt.bootstrap(frame(i), float(ts[i]))
        i += 1

    def chunk():
        nonlocal i
        tt.track_batch(tst.batch_from_frames([frame(k) for k in range(i, i + 8)], ts[i:i + 8]))
        i += 8

    for _ in range(n_chunks):
        chunk()
    return tt, chunk


def test_chunked_per_frame_iforest_and_frozen_objects(monkeypatch):
    """``ObjectConfig.per_frame_iforest`` on the chunked path: the cull runs
    inside every object pass (run_iforest=True, draws from the carry's
    generator) and never once a chunk; in localization mode the object map
    is frozen (no object pass, no cull)."""
    import dataclasses

    from eao_slam_torch.runtime import scan_tracker as tst

    cfg = torch_object_config("EAO")
    cfg = cfg.replace(objects=dataclasses.replace(cfg.objects, per_frame_iforest=True))
    calls = []
    orig = tst.apply_frame_update

    def counted(*args, **kw):
        calls.append(kw.get("run_iforest"))
        return orig(*args, **kw)

    def no_chunk_cull(*args, **kw):
        raise AssertionError("the chunk-rate cull ran with per_frame_iforest")

    monkeypatch.setattr(tst, "apply_frame_update", counted)
    monkeypatch.setattr(tst, "chunk_iforest_cull", no_chunk_cull)
    tt, chunk = _chunked_eao(cfg, 2)
    assert calls and all(calls)
    assert int((tt.carry.table.valid & ~tt.carry.table.bad).sum()) >= 2
    tt.set_localization_mode(True)
    before = (n(tt.carry.m.pt_object_id).copy(), table_numpy(tt.carry.table))
    n_calls = len(calls)
    chunk()
    assert len(calls) == n_calls
    np.testing.assert_array_equal(n(tt.carry.m.pt_object_id), before[0])
    for f, v in table_numpy(tt.carry.table).items():
        np.testing.assert_array_equal(v, before[1][f], err_msg=f)
