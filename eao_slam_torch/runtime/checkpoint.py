"""Checkpoint and resume of both trackers.

The interactive MonoTracker's map checkpoint is the reference package's
version 1 (``save_checkpoint`` / ``load_checkpoint``): the MapState as
``map_*``, the object table as ``obj_*``, the host mirrors, and a JSON blob
``meta`` of the keyframe order and counters; a restored tracker resumes
LOST and relocalizes into the map.

The chunked checkpoint is the reference package's format (version 2,
``np.savez_compressed``): the whole ChunkCarry as ``m_*`` (map) and ``c_*``
(carry) arrays, the loop closer's signatures as ``lc_signatures``, and a
JSON blob of host state under ``chunked_meta``. A file the reference wrote
loads here, so the loader also carries a reference run's state across
(beside ``convert.py``). Arrays keep the reference's dtypes: descriptors
are written as uint32.

Where the port differs:
- the loop RNG and the iForest RNG are ``torch.Generator``s; their states
  are saved in the arrays ``loop_rng_state`` and ``iforest_rng_state``.
  The reference's ``jax.random`` keys (``loop_rng`` in the meta, the
  carry's ``c_obj_key``) cannot seed them, so a file without those arrays
  resumes with generators seeded afresh from the config, with a warning;
- the object table is written as ``t_*`` arrays, as the reference writes
  it, in the object-layer modes only (the reference writes a one-slot
  dummy table in geometry mode, which the port ignores);
- consistency-streak groups are written as Python ints: the reference
  writes the members as they are and ``json.dumps`` fails on numpy
  integers (``ROADMAP.md`` Queue 3).

The retained keyframe images of FULL mode go in as the reference writes
them: ``kf_image_slots`` (int32, sorted) and ``kf_images`` (float32 [n, H,
W]), both absent when there are none.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch

from eao_slam_torch.convert import (carry_from_numpy, carry_to_numpy, map_state_from_numpy,
                                    map_state_to_numpy, object_table_from_numpy,
                                    object_table_to_numpy)
from eao_slam_torch.runtime.loop_closing import kf_signatures
from eao_slam_torch.runtime.map_state import MapState
from eao_slam_torch.runtime.scan_tracker import ChunkCarry
from eao_slam_torch.runtime.tracker import LOST

FORMAT_VERSION = 1
CHUNKED_VERSION = 2


def save_checkpoint(path: str, tracker) -> None:
    """Serialize a MonoTracker's map, object table and host mirrors."""
    arrays = {f"map_{k}": v for k, v in map_state_to_numpy(tracker.map).items()}
    if tracker.obj_table is not None:
        arrays.update({f"obj_{k}": v for k, v in object_table_to_numpy(tracker.obj_table).items()})
    for name in ("kf_pt_host", "kf_valid_host", "pt_valid_host", "pt_first_kf_host"):
        arrays[name] = getattr(tracker, name)
    meta = {"version": FORMAT_VERSION, "kf_slots": [int(s) for s in tracker.kf_slots],
            "frame_id": int(tracker.frame_id), "n_points": int(tracker.n_points),
            "state": int(tracker.state), "flag": tracker.cfg.flag.value}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, meta=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, tracker) -> dict:
    """Restore a MonoTracker checkpoint (the port's or the reference's)
    into a tracker of the same capacities. The tracker resumes LOST, with
    the last keyframe's pose, and relocalizes into the restored map; the
    loop closer's signatures are recomputed. Returns the meta dict."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    m = {k: data[f"map_{k}"] for k in MapState._fields}
    for k, a in m.items():
        if tuple(a.shape) != tuple(getattr(tracker.map, k).shape):
            raise ValueError(f"checkpoint field {k} shape {a.shape} != capacity "
                             f"{tuple(getattr(tracker.map, k).shape)}")
    tracker.map = map_state_from_numpy(m, tracker.device)
    if tracker.obj_table is not None and "obj_valid" in data:
        tracker.obj_table = object_table_from_numpy(
            {k[4:]: data[k] for k in data.files if k.startswith("obj_")}, tracker.device)
    for name in ("kf_pt_host", "kf_valid_host", "pt_valid_host", "pt_first_kf_host"):
        setattr(tracker, name, data[name].copy())
    tracker.kf_slots = [int(s) for s in meta["kf_slots"]]
    tracker.frame_id = meta["frame_id"]
    tracker.n_points = meta["n_points"]
    tracker.state = LOST                    # relocalize into the map
    tracker.velocity = None
    tracker.last_T = (tracker.map.kf_pose[tracker.kf_slots[-1]].cpu().numpy()
                      if tracker.kf_slots else None)
    if tracker.loop_closer is not None and tracker.kf_slots:
        st = torch.as_tensor(tracker.kf_slots, device=tracker.device)
        tracker.loop_closer.signatures[tracker.kf_slots] = kf_signatures(
            tracker.map.kf_desc[st], tracker.map.kf_kp_valid[st]).cpu().numpy()
    return meta


def save_chunked_checkpoint(path: str, tracker, kf_images: dict = None) -> None:
    """Serialize a ChunkedTracker mid-sequence: the carry (with the object
    table and the iForest RNG's state in the object-layer modes), the
    trajectory records, the loop closer's state, the loop RNG's state and
    the System's retained keyframe images (slot -> [H, W])."""
    c = tracker.carry
    if c is None:
        raise RuntimeError("nothing to checkpoint: the tracker is not armed")
    d = carry_to_numpy(c)
    arrays = {f"m_{k}": v for k, v in d.pop("m").items()}
    table, obj_rng = d.pop("table"), d.pop("obj_rng")
    if table is not None:
        arrays.update({f"t_{k}": v for k, v in table.items()})
        arrays["iforest_rng_state"] = obj_rng
    arrays.update({f"c_{k}": v for k, v in d.items()})
    arrays["loop_rng_state"] = tracker.loop_rng.get_state().numpy()
    if kf_images:
        arrays["kf_image_slots"] = np.asarray(sorted(kf_images), np.int32)
        arrays["kf_images"] = np.stack([np.asarray(kf_images[s], np.float32)
                                        for s in sorted(kf_images)])
    lc = tracker.loop_closer
    if lc is not None:
        arrays["lc_signatures"] = lc.signatures
    meta = {
        "version": CHUNKED_VERSION,
        "flag": tracker.cfg.flag.value,
        "chunk": tracker.chunk,
        "records": [[float(t), None if T is None else np.asarray(T).tolist(), int(s)]
                    for t, T, s in tracker.records],
        "last_kf_slots": [[int(i), int(s)] for i, s in tracker.last_kf_slots],
        "n_maintenance": int(tracker.n_maintenance),
        "n_relocalized": int(tracker.n_relocalized),
        "n_object_merges": int(tracker.n_object_merges),
        "n_object_kills": int(tracker.n_object_kills),
        "loop_checked": int(tracker._loop_checked),
        "localization_only": bool(tracker._localization_only),
        "lc_streaks": ([[[int(s) for s in g], int(n)] for g, n in lc.consistent_streak.items()]
                       if lc is not None else []),
        "lc_last_loop_order": int(lc.last_loop_order) if lc is not None else -999,
        "lc_closed_loops": int(lc.closed_loops) if lc is not None else 0,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, chunked_meta=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def load_chunked_checkpoint(path: str, tracker) -> dict:
    """Restore a chunked checkpoint (the port's or the reference's) into a
    ChunkedTracker of the same capacities. Tracking resumes exactly where
    the save left off: state, motion model and last-frame block included.
    Returns the meta dict."""
    data = np.load(path, allow_pickle=False)
    if "chunked_meta" not in data:
        raise ValueError("not a chunked checkpoint")
    meta = json.loads(str(data["chunked_meta"]))
    if meta["version"] != CHUNKED_VERSION:
        raise ValueError(f"chunked checkpoint v{meta['version']} unsupported")
    if meta["flag"] != tracker.cfg.flag.value:
        raise ValueError(f"checkpoint flag {meta['flag']} != config {tracker.cfg.flag.value}")
    cap = tracker.cfg.capacity
    expect = {"m_kf_pose": (cap.max_keyframes, 3, 4), "m_pt_pos": (cap.max_points, 3),
              "c_last_kp": (cap.max_features, 2)}
    for k, shape in expect.items():
        if tuple(data[k].shape) != shape:
            raise ValueError(f"checkpoint field {k} shape {data[k].shape} != capacity {shape}")

    d = {k: data[f"c_{k}"] for k in ChunkCarry._fields
         if k not in ("m", "table", "obj_rng") and f"c_{k}" in data}
    d["m"] = {k[2:]: data[k] for k in data.files if k.startswith("m_")}
    cfg = tracker.cfg
    if cfg.flag.objects_enabled:
        if tuple(data["t_valid"].shape) != (cap.max_objects,):
            raise ValueError(f"checkpoint field t_valid shape {data['t_valid'].shape} != "
                             f"capacity {(cap.max_objects,)}")
        d["table"] = {k[2:]: data[k] for k in data.files if k.startswith("t_")}
        if "iforest_rng_state" in data:
            d["obj_rng"] = data["iforest_rng_state"]
    tracker.carry = carry_from_numpy(d, tracker.device)
    if cfg.flag.objects_enabled and tracker.carry.obj_rng is None:
        tracker.carry = tracker.carry._replace(
            obj_rng=torch.Generator().manual_seed(cfg.objects.iforest_seed))
        warnings.warn("the checkpoint holds no iForest generator state (a reference "
                      "file): the iForest RNG is seeded afresh from the config")
    tracker.kf_count_host = int(tracker.carry.kf_count)
    tracker.pt_count_host = int(tracker.carry.pt_count)
    tracker.state_host = int(tracker.carry.state)
    tracker.records = [(t, None if T is None else np.asarray(T, np.float32), s)
                       for t, T, s in meta["records"]]
    tracker.last_kf_slots = [tuple(x) for x in meta["last_kf_slots"]]
    tracker.n_maintenance = meta["n_maintenance"]
    tracker.n_relocalized = meta.get("n_relocalized", 0)
    tracker.n_object_merges = meta.get("n_object_merges", 0)
    tracker.n_object_kills = meta.get("n_object_kills", 0)
    tracker._loop_checked = meta["loop_checked"]
    # a checkpoint saved in localization mode resumes in it
    tracker.set_localization_mode(meta["localization_only"])
    if "loop_rng_state" in data:
        tracker.loop_rng.set_state(torch.as_tensor(data["loop_rng_state"]))
    else:
        tracker.loop_rng = torch.Generator().manual_seed(tracker.cfg.seed + 7)
        warnings.warn("the checkpoint holds no torch generator state (a reference "
                      "file): the loop RNG is seeded afresh from the config")
    if tracker.loop_closer is not None and "lc_signatures" in data:
        lc = tracker.loop_closer
        lc.signatures = data["lc_signatures"].astype(np.float32)
        lc.consistent_streak = {tuple(g): n for g, n in meta["lc_streaks"]}
        lc.last_loop_order = meta["lc_last_loop_order"]
        lc.closed_loops = meta["lc_closed_loops"]
    return meta


def load_kf_images(path: str) -> dict:
    """The retained keyframe images of a chunked checkpoint (the port's or
    the reference's): slot -> float32 [H, W], empty when it holds none."""
    data = np.load(path, allow_pickle=False)
    if "kf_image_slots" not in data:
        return {}
    images = data["kf_images"]
    return {int(s): images[j] for j, s in enumerate(data["kf_image_slots"])}
