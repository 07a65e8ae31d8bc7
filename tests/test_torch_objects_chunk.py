"""The slice as a whole: chunked tracking with the EAO object layer in the
port against the reference package's chunked tracker, its checkpoint, and
the System facade with each object-layer flag.

Whole-slice parity: the reference runs its own chunked EAO path (the
feature-level sequence of ``torch_parity.feature_sequence`` with
``project_boxes`` detections, chunk 8, as ``tests/test_objects_chunked.py``
does) through the bootstrap and three chunks, which populate its object
table; its ChunkCarry, table included, crosses to the port through
``convert.py``; then the same batch runs one chunk through both
``make_track_chunk``s, the chunk-rate iForest cull taking the reference's
draws. The reference's chunk compiles in about 20 s on a CPU, so the test
runs the chunk itself rather than replaying its stages.

Tolerances, as ``test_torch_scan_tracker.py`` holds geometry mode: integer
outputs (states, keyframe flags, inlier counts, allocators, point
bindings, object membership and votes, the object table's integer and
boolean fields) exact; poses 1e-4; point positions 1e-2 of the scene
depth, since new points come from a float32 triangulation summed in
another order (they differ by up to 7.3e-4 of a depth of 1.21 here); the
object table's point-derived floats (centres, spreads, extents) 1e-3 of
the depth, its centroid sums 1e-3 of the depth per observation (measured
at most 1.8e-4 and 5.1e-4 in all), its projected rects 0.05 pixel
(measured 4.6e-3).
"""

from functools import lru_cache

import numpy as np
import pytest
from eao_slam_torch.convert import carry_from_numpy, carry_to_numpy
from eao_slam_torch.runtime import checkpoint as tck, scan_tracker as tst
from eao_slam_torch.runtime.frame import frame_from_arrays as tframe
from eao_slam_torch.system import System
from torch_objects import (jax_object_config, reference_iforest_draws, table_numpy,
                           torch_object_config)
from torch_parity import feature_sequence, jax_carry_numpy, n, t

CHUNK = 8
PIXEL_FIELDS = ("last_rect", "last_last_rect", "proj_rect")
SUM_FIELDS = ("cent_sum", "cent_sumsq")


def _boxes(k):
    from eao_slam_torch.geometry.camera import TUM3
    from eao_slam_torch.io.synthetic import project_boxes

    return project_boxes(_scene(), TUM3, feature_sequence()[1][k], 8)


@lru_cache(maxsize=None)
def _scene():
    from eao_slam_torch.io.synthetic import make_room_scene

    return make_room_scene(seed=3, n_landmarks=1200, n_objects=3)


def jax_frames(cfg, lo, hi):
    from eao_slam_tpu.runtime.frame import frame_from_arrays

    _, _, obs = feature_sequence()
    out = []
    for k in range(lo, hi):
        o, (b, c, s, v) = obs[k], _boxes(k)
        out.append(frame_from_arrays(cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                     valid=o["valid"], boxes=b, box_class=c, box_score=s,
                                     box_valid=v))
    return out


def torch_frames(cfg, lo, hi):
    ts, _, obs = feature_sequence()
    return [(tframe(cfg, kp=obs[k]["kp"], desc=obs[k]["desc"], octave=obs[k]["octave"],
                    valid=obs[k]["valid"], boxes=_boxes(k)), float(ts[k]))
            for k in range(lo, hi)]


@lru_cache(maxsize=None)
def reference_run():
    """The reference's chunked EAO tracker through the bootstrap and three
    chunks, as ``track_batch`` runs them. Returns (tracker after them, index
    of the next frame, and per chunk: the carry before it, its batch, the
    chunk program's carry and outputs)."""
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker, batch_from_frames

    cfg = jax_object_config()
    ts, _, _ = feature_sequence()
    tr = ChunkedTracker(cfg, chunk=CHUNK)
    i = 0
    while tr.carry is None:
        tr.bootstrap(jax_frames(cfg, i, i + 1)[0], float(ts[i]))
        i += 1
    assert not np.asarray(tr.carry.table.valid).any()   # the bootstrap runs no object pass
    chunks = []
    for _ in range(3):
        batch = batch_from_frames(jax_frames(cfg, i, i + CHUNK), ts[i:i + CHUNK],
                                  with_boxes=True)
        before, kf_before = tr.carry, tr.kf_count_host
        after, outs = tr._track_chunk(before, batch)
        chunks.append((before, batch, after, outs))
        tr.carry = after
        tr._after_chunk(outs, ts[i:i + CHUNK], kf_before)
        i += CHUNK
    return tr, i, chunks


def reference_cull_draws(obj_key, n_live: int):
    """draw_iforest's stand-in: the draws of the reference's chunk-rate
    cull after a chunk of ``n_live`` live frames (the key splits once per
    live frame, then once for the cull)."""
    import jax

    key = obj_key
    for _ in range(n_live):
        key, _ = jax.random.split(key)
    _, k_cull = jax.random.split(key)
    return lambda generator, mask, psi, depth: reference_iforest_draws(k_cull, mask, psi, depth)


def _depth(m):
    return np.abs(m["pt_pos"][m["pt_valid"]]).max()


def assert_chunk_state_equal(a: dict, b: dict, tag: str):
    """a, b: carries as numpy dicts (convert.py's layout, tables included)."""
    for k in ("kf_pt_idx", "kf_valid", "kf_by_object", "pt_valid", "pt_object_id",
              "pt_obj_votes"):
        np.testing.assert_array_equal(a["m"][k], b["m"][k], err_msg=f"{tag}: {k}")
    np.testing.assert_allclose(a["m"]["kf_pose"], b["m"]["kf_pose"], atol=1e-4)
    depth = _depth(b["m"])
    np.testing.assert_allclose(a["m"]["pt_pos"], b["m"]["pt_pos"], atol=1e-2 * depth)
    for f, w in b["table"].items():
        g = a["table"][f]
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{tag}: table {f}")
        elif f in PIXEL_FIELDS:
            np.testing.assert_allclose(g, w, atol=0.05, err_msg=f"{tag}: table {f}")
        else:
            per_obs = np.maximum(b["table"]["n_obs"], 1)[:, None] if f in SUM_FIELDS else 1
            assert (np.abs(g - w) <= 1e-3 * depth * per_obs).all(), f"{tag}: table {f}"
    for k in ("state", "kf_count", "pt_count", "frame_id", "frames_since_kf", "vel_ok"):
        assert int(a[k]) == int(b[k]), (tag, k)


@pytest.mark.parametrize("k", [0, 2])
def test_one_eao_chunk_parity(monkeypatch, k):
    """Chunk 0 creates the objects, and the first of them forces a
    keyframe flagged as an object keyframe; chunk 2 starts from a table of
    objects observed 16 times (past the t-test's 8) and inserts a
    keyframe, so the window BA and the cull run after the object pass."""
    before, batch_j, cj, oj = reference_run()[2][k]
    monkeypatch.setattr(tst, "draw_iforest", reference_cull_draws(before.obj_key, CHUNK))
    track = tst.make_track_chunk(torch_object_config())
    batch_t = tst.FrameBatch(**{f: t(getattr(batch_j, f)) for f in (
        "kp", "desc", "octave", "angle", "valid", "timestamp", "boxes", "box_class",
        "box_score", "box_valid")})
    ct, ot = track(carry_from_numpy(jax_carry_numpy(before, with_table=True), "cpu"), batch_t)

    for f in ("state", "is_kf", "n_inliers", "kf_count", "pt_count"):
        np.testing.assert_array_equal(getattr(ot, f), np.asarray(getattr(oj, f)), err_msg=f)
    np.testing.assert_allclose(ot.T, np.asarray(oj.T), atol=1e-4)
    assert_chunk_state_equal(carry_to_numpy(ct), jax_carry_numpy(cj, with_table=True), "chunk")
    assert ot.is_kf.any()
    if k == 0:
        assert n(ct.m.kf_by_object).any() and n(ct.table.valid).sum() >= 3
    else:
        assert n(before.table.n_obs).max() > 8


def test_reference_eao_checkpoint_resumes_in_the_port(monkeypatch, tmp_path):
    """A checkpoint the reference wrote in EAO mode loads into the port
    (its t_* arrays; both generators seeded afresh, with warnings), and the
    next chunk through ``track_batch`` (the between-chunk passes included)
    equals the reference's from the same file."""
    from eao_slam_tpu.runtime.checkpoint import (
        load_chunked_checkpoint as jload, save_chunked_checkpoint as jsave)
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker as JTracker, batch_from_frames

    jt0, i, _ = reference_run()
    path = str(tmp_path / "reference_eao.ckpt")
    jsave(path, jt0)
    ts, _, _ = feature_sequence()
    jt = JTracker(jt0.cfg, chunk=CHUNK)
    jload(path, jt)
    jt.track_batch(batch_from_frames(jax_frames(jt.cfg, i, i + CHUNK), ts[i:i + CHUNK],
                                     with_boxes=True))

    tt = tst.ChunkedTracker(torch_object_config(), chunk=CHUNK, device="cpu")
    with pytest.warns(UserWarning, match="iForest RNG is seeded afresh"):
        tck.load_chunked_checkpoint(path, tt)
    np.testing.assert_array_equal(n(tt.carry.table.n_obs), np.asarray(jt0.carry.table.n_obs))
    monkeypatch.setattr(tst, "draw_iforest", reference_cull_draws(jt0.carry.obj_key, CHUNK))
    frames = torch_frames(tt.cfg, i, i + CHUNK)
    tt.track_batch(tst.batch_from_frames([f for f, _ in frames], [s for _, s in frames]))
    assert_chunk_state_equal(carry_to_numpy(tt.carry), jax_carry_numpy(jt.carry, with_table=True),
                             "resumed chunk")
    assert tt.last_kf_slots == [tuple(int(v) for v in x) for x in jt.last_kf_slots]


def _drive(sysm, frames):
    for f, s in frames:
        sysm.track_frame(f, s)


def test_port_eao_checkpoint_resume_equals_the_uninterrupted_run(tmp_path):
    """Save mid-sequence through the System facade in EAO mode, restore
    into a fresh System, finish: trajectory and object table equal the
    uninterrupted run's to 1e-5, the iForest generator's state included."""
    cfg = torch_object_config()
    ts, _, _ = feature_sequence()
    frames = torch_frames(cfg, 0, 36)
    solo = System(cfg, chunk=CHUNK, device="cpu")
    n_boot = 0
    for f, s in frames:
        solo.track_frame(f, s)
        n_boot += not solo._armed
    solo.flush()
    half = n_boot + 1 + 2 * CHUNK
    first = System(cfg, chunk=CHUNK, device="cpu")
    _drive(first, frames[:half])
    assert not first._frame_buf
    path = str(tmp_path / "eao.ckpt")
    first.save_checkpoint(path)
    resumed = System(cfg, chunk=CHUNK, device="cpu")
    resumed.load_checkpoint(path)
    assert resumed.tracker.carry.obj_rng.get_state().equal(
        first.tracker.carry.obj_rng.get_state())
    _drive(resumed, frames[half:])
    resumed.flush()
    ts_a, T_a = solo.tracker.frame_trajectory()
    ts_b, T_b = resumed.tracker.frame_trajectory()
    np.testing.assert_array_equal(ts_b, ts_a)
    np.testing.assert_allclose(T_b, T_a, atol=1e-5)
    a, b = table_numpy(resumed.tracker.obj_table), table_numpy(solo.tracker.obj_table)
    assert a["valid"].sum() >= 2
    for f in a:
        np.testing.assert_allclose(a[f], b[f], atol=1e-5, err_msg=f)


@pytest.mark.parametrize("flag", ["iForest", "NA", "IoU", "NP"])
def test_system_runs_each_object_flag(flag):
    """The ablation flags construct and run the chunked path with boxes on
    the CPU: objects form, each object's class is a scene class, and the
    tracker stays OK."""
    cfg = torch_object_config(flag)
    sysm = System(cfg, chunk=CHUNK, device="cpu")
    _drive(sysm, torch_frames(cfg, 0, 3 + 2 * CHUNK))
    sysm.flush()
    assert sysm.tracker.armed and sysm.tracker.state == tst.OK
    tab = sysm.tracker.obj_table
    live = n(tab.valid) & ~n(tab.bad)
    assert live.sum() >= 1
    assert set(n(tab.cls)[live].tolist()) <= set(_scene().obj_classes.tolist())
