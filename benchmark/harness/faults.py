"""Faults planted under a run, to show that ``correct`` catches them and to
read the numbers they give at a cell's own size (``control.py --fault``).
Each takes the run's ``Drive`` before set-up and a ``setattr(owner, name,
value)`` that the caller undoes after the run (pytest's ``monkeypatch``, or
a plain ``setattr`` in a process that ends with the run).

``stateless``   the step returns its state unchanged: the chunk's frames are
                extracted but every pose is the last one (chunked), or the
                per-frame tracker returns the last pose (live)
``coast``       half of the batch left out at the tracker: the second half
                of every chunk's poses (chunked), or every other frame's
                pose (live, without tracking it), extrapolated at constant
                velocity from the two before
``half_chunk``  half of the chunk left out at the front end: the second
                half's features are the first half's (chunked)
``altered``     an answer altered where it is produced: one keypoint of the
                first frame of every chunk (or of every frame) moved a pixel
``objects_shifted``  the object table's centres moved by one map unit on each
                axis after every chunk (or frame), where they are produced

One card per cell: there is no exchange between cards to leave out.
"""

from __future__ import annotations

import numpy as np
import torch


def stateless(drive, setattr_):
    if drive.mode == "chunked":
        from eao_slam_torch.runtime import scan_tracker as st

        cfg = drive.cfg

        def extract_track(carry, images_u8, timestamps, active=None, boxes=None):
            st.extract_batch(cfg, images_u8, timestamps, active, boxes)
            C = images_u8.shape[0]
            T = np.repeat(carry.T_last.cpu().numpy()[None], C, 0)
            return carry, st.ChunkOutputs(
                T=T, state=np.full(C, 2, np.int32), n_inliers=np.zeros(C, np.int32),
                is_kf=np.zeros(C, bool), kf_count=np.full(C, carry.kf_count, np.int32),
                pt_count=np.full(C, carry.pt_count, np.int32))

        setattr_(drive.system.tracker, "_extract_track", extract_track)
    else:
        from eao_slam_torch.runtime.tracker import MonoTracker

        original = MonoTracker._track_frame

        def track_frame(self, frame, timestamp):
            if self.state != 2:             # not yet tracking: let it initialize
                return original(self, frame, timestamp)
            return self.last_T

        setattr_(MonoTracker, "_track_frame", track_frame)


def _extrapolate(T_prev: np.ndarray, T_last: np.ndarray, steps: int) -> np.ndarray:
    """The constant-velocity pose ``steps`` frames after T_last [3, 4]."""
    def h(T):
        return np.vstack([np.asarray(T, np.float64), [0.0, 0.0, 0.0, 1.0]])

    V = h(T_last) @ np.linalg.inv(h(T_prev))
    return (np.linalg.matrix_power(V, steps) @ h(T_last))[:3].astype(np.float32)


def coast(drive, setattr_):
    if drive.mode == "chunked":
        tracker = drive.system.tracker
        original = tracker._extract_track

        def extract_track(carry, images_u8, timestamps, active=None, boxes=None):
            carry, outs = original(carry, images_u8, timestamps, active, boxes)
            T = np.array(outs.T, np.float32)
            h = T.shape[0] // 2
            if h >= 2 and (outs.state[h - 2:h] == 2).all():
                for j in range(h, T.shape[0]):
                    T[j] = _extrapolate(T[h - 2], T[h - 1], j - h + 1)
            return carry, outs._replace(T=T)

        setattr_(tracker, "_extract_track", extract_track)
    else:
        from eao_slam_torch.runtime.tracker import MonoTracker

        original = MonoTracker._track_frame
        seen = []                           # the poses the tracker returned

        def track_frame(self, frame, timestamp):
            if len(seen) >= 2 and len(seen) % 2 == 0:
                T = _extrapolate(seen[-2], seen[-1], 1)
            else:
                T = original(self, frame, timestamp)
            if T is not None:
                seen.append(np.asarray(T))
            return T

        setattr_(MonoTracker, "_track_frame", track_frame)


def half_chunk(drive, setattr_):
    from eao_slam_torch.runtime import scan_tracker as st

    original = st.extract_batch

    def extract_batch(cfg, images_u8, timestamps, active=None, boxes=None, mesh=None):
        out = original(cfg, images_u8, timestamps, active, boxes, mesh)
        h = images_u8.shape[0] // 2
        rep = lambda x: torch.cat([x[:h], x[:x.shape[0] - h]])  # noqa: E731
        return out._replace(kp=rep(out.kp), desc=rep(out.desc), octave=rep(out.octave),
                            angle=rep(out.angle), valid=rep(out.valid))

    setattr_(st, "extract_batch", extract_batch)


def altered(drive, setattr_):
    if drive.mode == "chunked":
        from eao_slam_torch.runtime import scan_tracker as owner

        name = "extract_batch"
    else:
        from eao_slam_torch import system as owner

        name = "frame_from_image"
    original = getattr(owner, name)

    def moved(*args, **kw):
        out = original(*args, **kw)
        kp = out.kp.clone()
        kp[(0,) * (kp.dim() - 1)] += 1.0     # x of the first keypoint of the first frame
        return out._replace(kp=kp)

    setattr_(owner, name, moved)


def objects_shifted(drive, setattr_, shift: float = 1.0):
    if drive.mode == "chunked":
        from eao_slam_torch.runtime.scan_tracker import ChunkedTracker

        original = ChunkedTracker._maybe_merge_objects

        def merge(self):
            original(self)
            t = self.carry.table
            self.carry = self.carry._replace(table=t._replace(center=t.center + shift))

        setattr_(ChunkedTracker, "_maybe_merge_objects", merge)
    else:
        from eao_slam_torch.runtime.tracker import MonoTracker

        original = MonoTracker._track_frame

        def track_frame(self, frame, timestamp):
            out = original(self, frame, timestamp)
            if self.obj_table is not None:
                self.obj_table = self.obj_table._replace(center=self.obj_table.center + shift)
            return out

        setattr_(MonoTracker, "_track_frame", track_frame)


FAULTS = {"stateless": stateless, "coast": coast, "half_chunk": half_chunk, "altered": altered,
          "objects_shifted": objects_shifted}
