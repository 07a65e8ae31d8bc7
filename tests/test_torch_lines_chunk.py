"""The slice as a whole: chunked tracking with line-alignment yaw
(DemoFlag.LINE_IFOREST) in the port against the reference package's
chunked tracker, its checkpoint, and the System facade.

The frames are ``test_torch_objects_chunk.py``'s (the feature-level
sequence of ``torch_parity.feature_sequence`` with ``project_boxes``
detections, chunk 8) with line segments added: the projected edges of the
scene's cuboids turned by 7 degrees about the vertical, so that the yaw
vote has evidence. (At a yaw of 0 the samples at -1.55 and +1.55 degrees
see mirror images of the same edges, their mean errors tie to the last
float32 bit, and rounding noise elects either, in either package.) The
reference runs its own chunked line path through the bootstrap and three
chunks; its carry,
object table included, crosses to the port through ``convert.py``; then
the same batch runs one chunk through both ``make_track_chunk``s, the
chunk-rate iForest cull taking the reference's draws.

Tolerances as ``test_torch_objects_chunk.py`` holds the EAO chunk
(integers exact, poses 1e-4, the table's point-derived floats 1e-3 of the
depth), and ``yaw_hist`` 1e-4, the elected yaw the same sample (1e-6 rad,
see ``test_torch_yaw.py`` on the reference's grid).
"""

from functools import lru_cache

import numpy as np
import pytest

from eao_slam_torch.convert import carry_from_numpy, carry_to_numpy
from eao_slam_torch.runtime import checkpoint as tck, scan_tracker as tst
from eao_slam_torch.runtime.frame import frame_from_arrays as tframe
from eao_slam_torch.system import System
from test_torch_objects_chunk import (_boxes, _scene, assert_chunk_state_equal,
                                      reference_cull_draws)
from torch_objects import jax_object_config, table_numpy, torch_object_config
from torch_parity import feature_sequence, jax_carry_numpy, n, t

CHUNK = 8
FLAG = "LineAndiForest"
MAX_LINES = 128
# the 12 edges of a cuboid over corners indexed by (sx, sy, sz) bits
EDGES = [(a, b) for a in range(8) for b in range(a + 1, 8) if bin(a ^ b).count("1") == 1]
LINE_YAW = np.deg2rad(7.0)


@lru_cache(maxsize=None)
def _lines(k):
    """Frame k's line segments: the scene's cuboid edges, turned by LINE_YAW
    about the vertical through the centre, projected with the true pose,
    both ends in front of the camera; [MAX_LINES, 4], [MAX_LINES]."""
    from eao_slam_torch.geometry.camera import TUM3

    scene, T = _scene(), feature_sequence()[1][k]
    lines = np.zeros((MAX_LINES, 4), np.float32)
    valid = np.zeros((MAX_LINES,), bool)
    cy, sy_ = np.cos(LINE_YAW), np.sin(LINE_YAW)
    R = np.array([[cy, 0.0, sy_], [0.0, 1.0, 0.0], [-sy_, 0.0, cy]])
    i = 0
    for c, size in zip(scene.obj_centers, scene.obj_sizes):
        s = size / 2
        corners = c + np.array([[sx, sy, sz] for sx in (-s[0], s[0]) for sy in (-s[1], s[1])
                                for sz in (-s[2], s[2])]) @ R.T
        xc = corners @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([TUM3.fx * xc[:, 0] / xc[:, 2] + TUM3.cx,
                       TUM3.fy * xc[:, 1] / xc[:, 2] + TUM3.cy], 1)
        for a, b in EDGES:
            if xc[a, 2] > 0.1 and xc[b, 2] > 0.1:
                lines[i] = (*uv[a], *uv[b])
                valid[i] = True
                i += 1
    return lines, valid


def jax_frames(cfg, lo, hi):
    from eao_slam_tpu.runtime.frame import frame_from_arrays

    _, _, obs = feature_sequence()
    out = []
    for k in range(lo, hi):
        o, (b, c, s, v), (ln, lv) = obs[k], _boxes(k), _lines(k)
        out.append(frame_from_arrays(cfg, kp=o["kp"], desc=o["desc"], octave=o["octave"],
                                     valid=o["valid"], boxes=b, box_class=c, box_score=s,
                                     box_valid=v, lines=ln, line_valid=lv))
    return out


def torch_frames(cfg, lo, hi):
    ts, _, obs = feature_sequence()
    return [(tframe(cfg, kp=obs[k]["kp"], desc=obs[k]["desc"], octave=obs[k]["octave"],
                    valid=obs[k]["valid"], boxes=_boxes(k), lines=_lines(k)[0],
                    line_valid=_lines(k)[1]), float(ts[k]))
            for k in range(lo, hi)]


@lru_cache(maxsize=None)
def reference_run():
    """The reference's chunked line-mode tracker through the bootstrap and
    three chunks. Returns (tracker after them, index of the next frame, and
    per chunk: the carry before it, its batch, the chunk program's carry
    and outputs)."""
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker, batch_from_frames

    cfg = jax_object_config(FLAG)
    ts, _, _ = feature_sequence()
    tr = ChunkedTracker(cfg, chunk=CHUNK)
    i = 0
    while tr.carry is None:
        tr.bootstrap(jax_frames(cfg, i, i + 1)[0], float(ts[i]))
        i += 1
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


def assert_yaw_equal(a: dict, b: dict, tag: str):
    np.testing.assert_allclose(a["yaw_hist"], b["yaw_hist"], atol=1e-4, err_msg=tag)
    np.testing.assert_allclose(a["yaw"], b["yaw"], rtol=0, atol=1e-6, err_msg=tag)


@pytest.mark.parametrize("k", [0, 2])
def test_one_line_chunk_parity(monkeypatch, k):
    """Chunk 0 creates the objects and casts their first yaw votes; chunk 2
    starts from objects with votes past the election's 3."""
    before, batch_j, cj, oj = reference_run()[2][k]
    monkeypatch.setattr(tst, "draw_iforest", reference_cull_draws(before.obj_key, CHUNK))
    track = tst.make_track_chunk(torch_object_config(FLAG))
    batch_t = tst.FrameBatch(**{f: t(getattr(batch_j, f)) for f in (
        "kp", "desc", "octave", "angle", "valid", "timestamp", "boxes", "box_class",
        "box_score", "box_valid", "lines", "line_valid")})
    ct, ot = track(carry_from_numpy(jax_carry_numpy(before, with_table=True), "cpu"), batch_t)

    for f in ("state", "is_kf", "n_inliers", "kf_count", "pt_count"):
        np.testing.assert_array_equal(getattr(ot, f), np.asarray(getattr(oj, f)), err_msg=f)
    np.testing.assert_allclose(ot.T, np.asarray(oj.T), atol=1e-4)
    got, want = carry_to_numpy(ct), jax_carry_numpy(cj, with_table=True)
    assert_chunk_state_equal(got, want, "chunk")
    assert_yaw_equal(got["table"], want["table"], "chunk")
    votes = want["table"]["yaw_hist"][..., 0].sum(1)
    assert votes.sum() > 0
    if k == 2:
        assert (votes >= 3).any()


def test_lines_default_to_none_in_a_batch():
    """A line-mode batch without line fields tracks as if every frame had
    no segments: no yaw votes, the rest as with zero lines."""
    before, batch_j, _, _ = reference_run()[2][0]
    cfg = torch_object_config(FLAG)
    fields = ("kp", "desc", "octave", "angle", "valid", "timestamp", "boxes", "box_class",
              "box_score", "box_valid")
    batch = tst.FrameBatch(**{f: t(getattr(batch_j, f)) for f in fields})
    zero = batch._replace(lines=t(np.zeros((CHUNK, MAX_LINES, 4), np.float32)),
                          line_valid=t(np.zeros((CHUNK, MAX_LINES), bool)))
    carry = jax_carry_numpy(before, with_table=True)
    outs = [tst.make_track_chunk(cfg)(carry_from_numpy(carry, "cpu"), b) for b in (batch, zero)]
    (ca, oa), (cb, ob) = outs
    np.testing.assert_array_equal(oa.T, ob.T)
    assert not n(ca.table.yaw_hist).any() and not n(cb.table.yaw_hist).any()


def test_reference_line_checkpoint_resumes_in_the_port(monkeypatch, tmp_path):
    """A checkpoint the reference wrote in line mode loads into the port,
    and the next chunk through ``track_batch`` (the between-chunk passes
    included) equals the reference's from the same file, yaw included."""
    from eao_slam_tpu.runtime.checkpoint import (
        load_chunked_checkpoint as jload, save_chunked_checkpoint as jsave)
    from eao_slam_tpu.runtime.scan_tracker import ChunkedTracker as JTracker, batch_from_frames

    jt0, i, _ = reference_run()
    path = str(tmp_path / "reference_line.ckpt")
    jsave(path, jt0)
    ts, _, _ = feature_sequence()
    jt = JTracker(jt0.cfg, chunk=CHUNK)
    jload(path, jt)
    jt.track_batch(batch_from_frames(jax_frames(jt.cfg, i, i + CHUNK), ts[i:i + CHUNK],
                                     with_boxes=True))

    tt = tst.ChunkedTracker(torch_object_config(FLAG), chunk=CHUNK, device="cpu")
    with pytest.warns(UserWarning, match="iForest RNG is seeded afresh"):
        tck.load_chunked_checkpoint(path, tt)
    assert_yaw_equal(table_numpy(tt.carry.table),
                     {k: np.asarray(v) for k, v in jt0.carry.table._asdict().items()}, "loaded")
    monkeypatch.setattr(tst, "draw_iforest", reference_cull_draws(jt0.carry.obj_key, CHUNK))
    frames = torch_frames(tt.cfg, i, i + CHUNK)
    tt.track_batch(tst.batch_from_frames([f for f, _ in frames], [s for _, s in frames]))
    got, want = carry_to_numpy(tt.carry), jax_carry_numpy(jt.carry, with_table=True)
    assert_chunk_state_equal(got, want, "resumed chunk")
    assert_yaw_equal(got["table"], want["table"], "resumed chunk")


def test_port_line_checkpoint_resume_equals_the_uninterrupted_run(tmp_path):
    """Save mid-sequence through the System facade in line mode, restore
    into a fresh System, finish: trajectory and object table (yaw votes
    included) equal the uninterrupted run's to 1e-5."""
    cfg = torch_object_config(FLAG)
    frames = torch_frames(cfg, 0, 36)
    solo = System(cfg, chunk=CHUNK, device="cpu")
    n_boot = 0
    for f, s in frames:
        solo.track_frame(f, s)
        n_boot += not solo._armed
    solo.flush()
    half = n_boot + 1 + 2 * CHUNK
    first = System(cfg, chunk=CHUNK, device="cpu")
    for f, s in frames[:half]:
        first.track_frame(f, s)
    assert not first._frame_buf
    path = str(tmp_path / "line.ckpt")
    first.save_checkpoint(path)
    resumed = System(cfg, chunk=CHUNK, device="cpu")
    resumed.load_checkpoint(path)
    for f, s in frames[half:]:
        resumed.track_frame(f, s)
    resumed.flush()
    ts_a, T_a = solo.tracker.frame_trajectory()
    ts_b, T_b = resumed.tracker.frame_trajectory()
    np.testing.assert_array_equal(ts_b, ts_a)
    np.testing.assert_allclose(T_b, T_a, atol=1e-5)
    a, b = table_numpy(resumed.tracker.obj_table), table_numpy(solo.tracker.obj_table)
    assert a["yaw_hist"][..., 0].sum() > 0
    for f in a:
        np.testing.assert_allclose(a[f], b[f], atol=1e-5, err_msg=f)
