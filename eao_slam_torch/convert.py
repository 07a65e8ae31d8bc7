"""State exchange with the reference package, through numpy.

The reference's MapState, ObjectTable and ChunkCarry cross as dicts of
numpy arrays (field name -> array, the carry's map under "m", its object
table under "table"). Descriptors are [.., 8] uint32 there and int32 with
the same bit pattern here; the boundary converts with ``.view``. The
carry's object table crosses both ways (None, or no "table" key, in
geometry mode). The port's iForest generator crosses as its state array
under "obj_rng"; the reference's ``jax.random`` key and its localization
switch cannot seed or set anything here and are ignored on the way in. A
LoopCloser's state crosses as a dict of its four attributes (signatures,
consistency streaks, the last loop's order, the number of closed loops). A
semi-dense result crosses as a dict of its five fields (pixels,
inv_depth, sigma, valid, points_w). The carry's localization switch
crosses as ``allow_kf`` (True when absent).

For the interactive tracker: a Vocabulary crosses as {"levels": [uint32
tables], "idf"}, a KeyFrameDatabase as {"vectors", "present"}, a Frame as
the dict of its fields, and a whole MonoTracker state as the dict
``mono_tracker_to_numpy`` gives (map, host mirrors, state machine, last
frame, velocity, object table, loop closer, vocabulary and database), so
both packages can start from one state mid-sequence. The reference's
``jax.random`` keys cannot cross; the port's generators keep their state.
"""

from __future__ import annotations

import numpy as np
import torch

from eao_slam_torch.config import SystemConfig
from eao_slam_torch.dense.semidense import SemiDenseResult
from eao_slam_torch.objects.state import ObjectTable
from eao_slam_torch.ops.bow import Vocabulary, _vocabulary
from eao_slam_torch.runtime.frame import Frame
from eao_slam_torch.runtime.keyframe_db import KeyFrameDatabase
from eao_slam_torch.runtime.loop_closing import LoopCloser
from eao_slam_torch.runtime.map_state import MapState
from eao_slam_torch.runtime.scan_tracker import ChunkCarry
from eao_slam_torch.runtime.tracker import MonoTracker

_DESC_FIELDS = ("kf_desc", "pt_desc", "last_desc", "desc")
_MONO_HOST = ("kf_pt_host", "kf_valid_host", "pt_valid_host", "pt_first_kf_host")
_MONO_SCALARS = ("n_points", "state", "frame_id", "frames_since_kf", "ref_kf_tracked",
                 "peak_since_kf")
_HOST_SCALARS = ("state", "frames_since_kf", "ref_kf_tracked", "peak_since_kf",
                 "kf_count", "pt_count", "frame_id")


def _to_tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _DESC_FIELDS:
        a = np.ascontiguousarray(a.astype(np.uint32)).view(np.int32)
    elif a.dtype in (np.int64, np.uint32):
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a), device=device)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in _DESC_FIELDS:
        a = np.ascontiguousarray(a).view(np.uint32)
    return a


def map_state_from_numpy(d: dict, device) -> MapState:
    return MapState(**{f: _to_tensor(f, d[f], device) for f in MapState._fields})


def map_state_to_numpy(m: MapState) -> dict:
    return {f: _to_numpy(f, getattr(m, f)) for f in MapState._fields}


def object_table_from_numpy(d: dict, device) -> ObjectTable:
    return ObjectTable(**{f: _to_tensor(f, d[f], device) for f in ObjectTable._fields})


def object_table_to_numpy(t: ObjectTable) -> dict:
    return {f: _to_numpy(f, getattr(t, f)) for f in ObjectTable._fields}


def carry_from_numpy(d: dict, device) -> ChunkCarry:
    kw = {}
    for f in ChunkCarry._fields:
        if f == "m":
            kw[f] = map_state_from_numpy(d["m"], device)
        elif f == "table":
            t = d.get("table")
            kw[f] = None if t is None else object_table_from_numpy(t, device)
        elif f == "obj_rng":
            state = d.get("obj_rng")
            kw[f] = None if state is None else \
                torch.Generator().set_state(torch.as_tensor(np.asarray(state, np.uint8)))
        elif f in _HOST_SCALARS:
            kw[f] = int(np.asarray(d[f]))
        elif f == "vel_ok":
            kw[f] = bool(np.asarray(d[f]))
        elif f == "allow_kf":
            kw[f] = bool(np.asarray(d.get(f, True)))
        else:
            kw[f] = _to_tensor(f, d[f], device)
    return ChunkCarry(**kw)


def carry_to_numpy(c: ChunkCarry) -> dict:
    out = {}
    for f in ChunkCarry._fields:
        v = getattr(c, f)
        if f == "m":
            out[f] = map_state_to_numpy(v)
        elif f == "table":
            out[f] = None if v is None else object_table_to_numpy(v)
        elif f == "obj_rng":
            out[f] = None if v is None else v.get_state().numpy()
        elif isinstance(v, torch.Tensor):
            out[f] = _to_numpy(f, v)
        else:
            out[f] = np.asarray(v)
    return out


def loop_closer_from_numpy(d: dict, cfg: SystemConfig) -> LoopCloser:
    """A LoopCloser holding the given state: ``signatures``,
    ``consistent_streak``, ``last_loop_order`` and ``closed_loops``, e.g.
    read off a reference LoopCloser with ``getattr``."""
    lc = LoopCloser(cfg)
    lc.signatures = np.array(d["signatures"], np.float32)
    lc.consistent_streak = {tuple(int(s) for s in g): int(n)
                            for g, n in d["consistent_streak"].items()}
    lc.last_loop_order = int(d["last_loop_order"])
    lc.closed_loops = int(d["closed_loops"])
    return lc


def semidense_result_from_numpy(d: dict, device) -> SemiDenseResult:
    """A SemiDenseResult from its fields as arrays, e.g. a reference
    result's ``_asdict()``."""
    return SemiDenseResult(**{f: _to_tensor(f, d[f], device) for f in SemiDenseResult._fields})


def semidense_result_to_numpy(r: SemiDenseResult) -> dict:
    return {f: _to_numpy(f, getattr(r, f)) for f in SemiDenseResult._fields}


def loop_closer_to_numpy(lc: LoopCloser) -> dict:
    return {"signatures": lc.signatures.copy(), "consistent_streak": dict(lc.consistent_streak),
            "last_loop_order": lc.last_loop_order, "closed_loops": lc.closed_loops}


def vocabulary_from_numpy(d: dict, device) -> Vocabulary:
    return _vocabulary(d["levels"], d["idf"], device)


def vocabulary_to_numpy(voc: Vocabulary) -> dict:
    return {"levels": [t.cpu().numpy().view(np.uint32) for t in voc.levels],
            "idf": voc.idf.cpu().numpy()}


def keyframe_db_from_numpy(d: dict, voc: Vocabulary) -> KeyFrameDatabase:
    db = KeyFrameDatabase(voc, int(np.asarray(d["present"]).shape[0]))
    db.vectors = np.array(d["vectors"], np.float32)
    db.present = np.array(d["present"], bool)
    return db


def frame_from_numpy(d: dict, device) -> Frame:
    return Frame(**{f: None if d.get(f) is None else _to_tensor(f, d[f], device)
                    for f in Frame._fields})


def frame_to_numpy(fr: Frame) -> dict:
    return {f: None if getattr(fr, f) is None else _to_numpy(f, getattr(fr, f))
            for f in Frame._fields}


def mono_tracker_to_numpy(t: MonoTracker) -> dict:
    """A MonoTracker's state mid-sequence as numpy (see the module doc)."""
    d = {"map": map_state_to_numpy(t.map), "kf_slots": list(t.kf_slots),
         "last_T": None if t.last_T is None else np.asarray(t.last_T),
         "velocity": None if t.velocity is None else np.asarray(t.velocity),
         "last_pt": None if t.last_pt is None else t.last_pt.cpu().numpy(),
         "last_frame": None if t.last_frame is None else frame_to_numpy(t.last_frame),
         "obj_table": None if t.obj_table is None else object_table_to_numpy(t.obj_table),
         "loop_closer": None if t.loop_closer is None else loop_closer_to_numpy(t.loop_closer),
         "vocab": None if t.vocab is None else vocabulary_to_numpy(t.vocab),
         "kfdb": None if t.kfdb is None else {"vectors": t.kfdb.vectors.copy(),
                                              "present": t.kfdb.present.copy()},
         "localization_only": t.localization_only}
    d.update({k: getattr(t, k).copy() for k in _MONO_HOST})
    d.update({k: int(getattr(t, k)) for k in _MONO_SCALARS})
    return d


def mono_tracker_from_numpy(d: dict, t: MonoTracker) -> MonoTracker:
    """Load a state (``mono_tracker_to_numpy``'s dict, or one read off a
    reference MonoTracker with the same keys) into the tracker ``t``, which
    keeps its generators. Returns ``t``."""
    dev = t.device
    t.map = map_state_from_numpy(d["map"], dev)
    t.kf_slots = [int(s) for s in d["kf_slots"]]
    for k in _MONO_HOST:
        setattr(t, k, np.array(d[k]))
    for k in _MONO_SCALARS:
        setattr(t, k, int(d[k]))
    t.last_T = None if d["last_T"] is None else np.array(d["last_T"], np.float32)
    t.velocity = None if d["velocity"] is None else np.array(d["velocity"], np.float32)
    t.last_pt = None if d["last_pt"] is None else _to_tensor("last_pt", d["last_pt"], dev)
    t.last_frame = None if d["last_frame"] is None else frame_from_numpy(d["last_frame"], dev)
    if d.get("obj_table") is not None:
        t.obj_table = object_table_from_numpy(d["obj_table"], dev)
    if d.get("loop_closer") is not None and t.loop_closer is not None:
        t.loop_closer = loop_closer_from_numpy(d["loop_closer"], t.cfg)
    t.vocab = None if d.get("vocab") is None else vocabulary_from_numpy(d["vocab"], dev)
    t.kfdb = None if d.get("kfdb") is None or t.vocab is None else \
        keyframe_db_from_numpy(d["kfdb"], t.vocab)
    t.localization_only = bool(d.get("localization_only", False))
    return t
