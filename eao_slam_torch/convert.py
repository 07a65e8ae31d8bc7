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
inv_depth, sigma, valid, points_w).
"""

from __future__ import annotations

import numpy as np
import torch

from eao_slam_torch.config import SystemConfig
from eao_slam_torch.dense.semidense import SemiDenseResult
from eao_slam_torch.objects.state import ObjectTable
from eao_slam_torch.runtime.loop_closing import LoopCloser
from eao_slam_torch.runtime.map_state import MapState
from eao_slam_torch.runtime.scan_tracker import ChunkCarry

_DESC_FIELDS = ("kf_desc", "pt_desc", "last_desc")
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
