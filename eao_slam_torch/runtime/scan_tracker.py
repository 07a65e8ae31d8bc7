"""Chunked tracking: C frames per dispatch.

Per frame: motion-model matching + robust pose LM (reference-keyframe
fallback), local-map matching + pose LM, with the EAO object layer on
(an object-layer DemoFlag) the object pass on a tracked frame with
detector boxes (detection statistics, the ensemble cascade, the table
update, with line-alignment yaw the yaw vote from the frame's line
segments; a new object forces a keyframe), the keyframe state machine and,
on keyframe frames only, keyframe insertion, epipolar triangulation with
the top covisible neighbours and map-point fusion. Once per chunk that
inserted a keyframe: windowed Schur BA, point culling and post-BA fusion;
with the object layer, once per chunk: the iForest outlier cull. Between
chunks, on the host: the object merge pass, map maintenance (keyframe cull
and slot compaction), loop closing and relocalization after a chunk that
ends LOST.

The reference runs this as one ``lax.scan`` with ``lax.cond`` branches;
here it is an eager per-frame Python loop whose branches are decided on
the host (two small readbacks per frame, one more per keyframe, one more
when the object pass ran and the keyframe decision needs its verdict).
Tensors stay on the tracker's device throughout.

The layers are stages of the port's tracer (``utils/profiling.TRACER``,
off unless turned on), one record a chunk: ``chunk.extract``,
``chunk.track`` with ``frame.motion``, ``frame.local_map``,
``frame.objects``, ``frame.keyframe`` (``keyframe.triangulate``,
``keyframe.fuse``), ``chunk.window_ba``, ``chunk.iforest`` and
``chunk.readback`` inside it, then ``chunk.record`` and the passes
``pass.merge_objects``, ``pass.maintain``, ``pass.close_loops``,
``pass.relocalize``; with the counters ``frames``, ``keyframes`` and
``motion_fallbacks``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from eao_slam_torch.config import SystemConfig
from eao_slam_torch.device import fp32_solvers, resolve_device
from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import undistort_points
from eao_slam_torch.objects.association import (
    N_OBJ_SAMPLE, apply_frame_update, chunk_iforest_cull, compute_detection_stats)
from eao_slam_torch.objects.iforest import draw_iforest, psi_depth_for
from eao_slam_torch.objects.merge import run_merge_pass
from eao_slam_torch.objects.resolve import resolve_cascade
from eao_slam_torch.objects.state import ObjectTable, empty_object_table
from eao_slam_torch.objects.stats import make_t_table
from eao_slam_torch.objects.yaw import update_yaw, yaw_sample_scores
from eao_slam_torch.ops import matching
from eao_slam_torch.ops.lines import detect_segments
from eao_slam_torch.ops.orb import extract_orb, scale_sigma2
from eao_slam_torch.parallel.distributed import all_gather_blocks
from eao_slam_torch.parallel.frames import frame_block, frame_block_len, gather_features
from eao_slam_torch.runtime import tracking_kernels as tk
from eao_slam_torch.runtime.compaction import covisibility, cull_and_compact
from eao_slam_torch.runtime.frame import Frame, empty_boxes
from eao_slam_torch.runtime.local_mapping import fuse_into_keyframe, triangulate_with_neighbor
from eao_slam_torch.runtime.loop_closing import LoopCloser, kf_signature, kf_signatures
from eao_slam_torch.runtime.map_state import MapState
from eao_slam_torch.runtime.tracker import MonoTracker
from eao_slam_torch.runtime.tracking_kernels import set_last_wins, set_rows_drop
from eao_slam_torch.solvers.ba import BAProblem, local_ba
from eao_slam_torch.solvers.pnp import pnp_ransac
from eao_slam_torch.utils.profiling import TRACER

OK = 2
LOST = 3


class ChunkCarry(NamedTuple):
    """State threaded from frame to frame and chunk to chunk. Tensors live
    on the tracker's device; scalars are host values (the per-frame
    branches read them on the host anyway)."""

    m: MapState
    T_last: torch.Tensor       # [3, 4]
    velocity: torch.Tensor     # [3, 4] (identity when vel_ok is False)
    vel_ok: bool
    last_kp: torch.Tensor      # [F, 2]
    last_desc: torch.Tensor    # [F, 8] int32
    last_octave: torch.Tensor  # [F]
    last_angle: torch.Tensor   # [F]
    last_valid: torch.Tensor   # [F]
    last_pt: torch.Tensor      # [F] int32
    state: int
    frames_since_kf: int
    ref_kf_tracked: int
    peak_since_kf: int
    kf_count: int              # monotonic keyframe slot allocator
    pt_count: int              # monotonic point slot allocator
    frame_id: int
    table: Optional[ObjectTable] = None       # object landmarks (object layer on)
    obj_rng: Optional[torch.Generator] = None  # host generator of the iForest draws
    # False in localization mode (mbOnlyTracking, src/Tracking.cc:245-257):
    # no keyframes, no BA, no object updates
    allow_kf: bool = True


class ChunkOutputs(NamedTuple):
    T: np.ndarray          # [C, 3, 4]
    state: np.ndarray      # [C]
    n_inliers: np.ndarray  # [C]
    is_kf: np.ndarray      # [C] bool
    kf_count: np.ndarray   # [C] allocator counters after each frame
    pt_count: np.ndarray   # [C]


class FrameBatch(NamedTuple):
    """Stacked front-end outputs of one chunk, [C, ...]."""

    kp: torch.Tensor
    desc: torch.Tensor
    octave: torch.Tensor
    angle: torch.Tensor
    valid: torch.Tensor
    timestamp: torch.Tensor  # [C]
    active: Optional[torch.Tensor] = None  # [C] bool; None = all live
    boxes: Optional[torch.Tensor] = None      # [C, B, 4]; None = no detections
    box_class: Optional[torch.Tensor] = None  # [C, B]
    box_score: Optional[torch.Tensor] = None  # [C, B]
    box_valid: Optional[torch.Tensor] = None  # [C, B]
    lines: Optional[torch.Tensor] = None      # [C, L, 4]; None = no segments
    line_valid: Optional[torch.Tensor] = None  # [C, L]


# ---------------------------------------------------------------------------
# keyframe branch pieces
# ---------------------------------------------------------------------------

def _insert_point_rows(m: MapState, slot: int, nb_slot, tri, pt_count: int,
                       scale_factors: torch.Tensor):
    """Scatter triangulated points into the point tables with the
    monotonic allocator (overflow drops). Returns (m, new pt_count)."""
    P = m.pt_pos.shape[0]
    good = tri.good
    rank = torch.cumsum(good.to(torch.int32), 0) - 1
    dest = torch.where(good, pt_count + rank, P)
    dest = torch.where(dest < P, dest, P).long()
    placed = good & (dest < P)

    X = tri.points
    T1 = m.kf_pose[slot]
    O1 = se3.trans(se3.inverse(T1))
    view = X - O1[None, :]
    dist = torch.linalg.norm(view, dim=-1)
    oct1 = torch.clamp(m.kf_octave[slot], 0, scale_factors.shape[0] - 1).long()
    max_d = dist * scale_factors[oct1]
    min_d = max_d / scale_factors[-1]
    normal = view / torch.clamp(dist, min=1e-9)[:, None]

    m = m._replace(
        pt_pos=set_rows_drop(m.pt_pos, dest, X),
        pt_valid=set_rows_drop(m.pt_valid, dest, placed),
        pt_desc=set_rows_drop(m.pt_desc, dest, m.kf_desc[slot]),
        pt_normal=set_rows_drop(m.pt_normal, dest, normal),
        pt_min_dist=set_rows_drop(m.pt_min_dist, dest, min_d),
        pt_max_dist=set_rows_drop(m.pt_max_dist, dest, max_d),
        pt_first_kf=set_rows_drop(m.pt_first_kf, dest,
                                  torch.full_like(dest, slot, dtype=torch.int32)),
    )
    dest32 = dest.to(torch.int32)
    row1 = torch.where(placed, dest32, m.kf_pt_idx[slot])
    nb_row = tk.scatter_max(m.kf_pt_idx[nb_slot], tri.idx2, torch.where(placed, dest32, -1))
    kf_pt_idx = m.kf_pt_idx.clone()
    kf_pt_idx[slot] = row1
    kf_pt_idx[nb_slot] = nb_row
    return m._replace(kf_pt_idx=kf_pt_idx), pt_count + int(placed.sum())


def _window_ba(cam, m: MapState, kf_count: int, W: int, Pl: int, scale2) -> MapState:
    """Windowed BA over the last W keyframes (5 + 10 LM schedule, oldest
    window keyframe fixed), compacting the window's points with a
    sort-based unique and scattering the results back.

    The local index of a point is taken from the last of its sorted
    occurrences, as the reference's scatter applies it on XLA's CPU
    backend: only points observed once in the window get a local index
    (see ROADMAP.md Queue 3)."""
    K, F = m.kf_pt_idx.shape
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    first = max(kf_count - W, 0)
    orders = first + torch.arange(W, device=dev)
    win = torch.clamp(orders, 0, K - 1)
    win_valid = orders < kf_count

    kf_pt = m.kf_pt_idx[win]
    obs_mask = (kf_pt >= 0) & m.kf_kp_valid[win] & win_valid[:, None]
    pt_of_obs = torch.where(obs_mask, kf_pt, P)
    flat = torch.sort(pt_of_obs.reshape(-1)).values
    is_first = (flat < P) & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                       flat[1:] != flat[:-1]])
    rank_sorted = torch.cumsum(is_first.to(torch.int32), 0) - 1
    keep_rank = is_first & (rank_sorted < Pl)
    remap = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)
    remap = set_last_wins(remap, flat, torch.where(keep_rank, rank_sorted, -1))
    remap[P] = -1
    local_pt = remap[torch.clamp(kf_pt, 0, P).long()]
    obs_ok = obs_mask & (local_pt >= 0)

    local2global = torch.full((Pl,), P, dtype=torch.int32, device=dev)
    local2global = set_rows_drop(local2global, torch.where(keep_rank, rank_sorted, Pl),
                                 torch.where(is_first, flat, P))
    lp_valid = local2global < P
    points0 = m.pt_pos[torch.clamp(local2global, 0, P - 1).long()]

    inv_s2 = 1.0 / scale2[torch.clamp(m.kf_octave[win], 0, scale2.shape[0] - 1).long()]
    kf_idx = torch.arange(W, device=dev)[:, None].expand(W, F)
    prob = BAProblem(
        poses=m.kf_pose[win],
        points=points0,
        kf_idx=kf_idx.reshape(-1),
        pt_idx=torch.clamp(local_pt, 0, Pl - 1).reshape(-1).long(),
        uv=m.kf_kp[win].reshape(-1, 2),
        inv_sigma2=inv_s2.reshape(-1),
        obs_valid=obs_ok.reshape(-1),
        cam_fixed=torch.arange(W, device=dev) < 1,
        cam_valid=win_valid,
        pt_valid=lp_valid,
    )
    res = local_ba(cam, prob)
    slot_or_drop = torch.where(win_valid, win, K)
    kf_pose = set_rows_drop(m.kf_pose, slot_or_drop, res.poses)
    pt_pos = set_rows_drop(m.pt_pos, local2global, res.points)
    inl = res.obs_inlier.reshape(W, F)
    new_rows = torch.where(obs_ok & ~inl, -1, kf_pt)
    kf_pt_idx = set_rows_drop(m.kf_pt_idx, slot_or_drop, new_rows)
    return m._replace(kf_pose=kf_pose, pt_pos=pt_pos, kf_pt_idx=kf_pt_idx)


def _cull_points(m: MapState, newest_slot: int) -> MapState:
    """MapPointCulling: points seen by fewer than 2 keyframes, other than
    those created by the newest keyframe, die (mask flip only)."""
    P = m.pt_pos.shape[0]
    obs = (m.kf_pt_idx >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    counts = torch.zeros(P, dtype=torch.int32, device=m.pt_pos.device).index_add_(
        0, torch.clamp(m.kf_pt_idx, 0, P - 1).reshape(-1).long(),
        obs.reshape(-1).to(torch.int32))
    stale = m.pt_valid & (counts < 2) & (m.pt_first_kf != newest_slot)
    return m._replace(pt_valid=m.pt_valid & ~stale)


# ---------------------------------------------------------------------------
# chunk program
# ---------------------------------------------------------------------------

def make_chunk_step(cfg: SystemConfig):
    """Per-frame step closed over the config: step(carry, frame, ts,
    has_boxes) -> (carry, (T, state, n_inliers, is_kf, kf_count, pt_count)).
    ``has_boxes`` (host bool: the frame has a valid detector box) gates the
    object pass."""
    cam = cfg.camera
    tcfg = cfg.tracking
    mcfg = cfg.mapping
    flag = cfg.flag
    n_tri_neighbors = min(8, mcfg.triangulation_neighbors)
    ratio32 = np.float32(tcfg.kf_tracked_ratio)
    scale2_by_device = {}
    t_table_by_device = {}

    psi, depth = psi_depth_for(N_OBJ_SAMPLE)

    def object_pass(m: MapState, table: ObjectTable, T, frame: Frame, cur_pt, frame_id,
                    gen: Optional[torch.Generator]):
        """The object work of TrackWithMotionModel (src/Tracking.cc:1246-1647)
        on the device: returns (m, table, appear_new as a device bool).
        With ``per_frame_iforest`` the iForest cull runs here, its draws
        from ``gen``."""
        dev = m.pt_pos.device
        if dev not in t_table_by_device:
            t_table_by_device[dev] = torch.as_tensor(make_t_table(), device=dev)
        det = compute_detection_stats(
            cam, m.pt_pos, m.pt_valid, m.pt_object_id, table, T, frame.kp, cur_pt,
            frame.boxes, frame.box_class, frame.box_score, frame.box_valid, frame_id)
        res = resolve_cascade(
            det, table, t_table_by_device[dev], frame.boxes, cfg.objects.proj_iou_threshold,
            use_iou=flag.use_iou, use_nonparam=flag.use_nonparam, use_ttest=flag.use_ttest,
            img_w=int(cam.width), img_h=int(cam.height),
            min_points=cfg.objects.min_points_per_object)
        # by default the iForest cull runs once per chunk
        # (chunk_iforest_cull in track_chunk), as in the reference package's
        # chunked tracker
        m, table = apply_frame_update(
            cam, m, table, det, res.assoc, res.new_slots, frame.boxes, frame.box_class, T,
            frame.kp, cur_pt, frame_id, draw=lambda mask: draw_iforest(gen, mask, psi, depth),
            depth=depth, run_iforest=cfg.objects.per_frame_iforest)
        table = table._replace(re_obj=table.re_obj + res.re_inc)
        if flag.use_yaw_lines:
            targets = torch.where(res.assoc >= 0, res.assoc, res.new_slots)
            counts, errs, n_lines = yaw_sample_scores(cam, table, targets, frame.boxes, T,
                                                      frame.lines, frame.line_valid)
            table = update_yaw(table, targets, counts, errs, n_lines)
        return m, table, (res.new_slots >= 0).any()

    def kf_branch(m: MapState, kf_count, pt_count, frame: Frame, ts, frame_id, T, cur_pt,
                  scale2, scale_factors, by_object):
        K = m.kf_pose.shape[0]
        P = m.pt_pos.shape[0]
        dev = m.pt_pos.device
        slot = min(kf_count, K - 1)
        upd = dict(kf_pose=T, kf_valid=True, kf_timestamp=ts, kf_frame_id=frame_id,
                   kf_kp=frame.kp, kf_desc=frame.desc, kf_octave=frame.octave,
                   kf_angle=frame.angle, kf_kp_valid=frame.valid, kf_pt_idx=cur_pt,
                   kf_by_object=by_object)
        new = {}
        for name, val in upd.items():
            arr = getattr(m, name).clone()
            arr[slot] = val
            new[name] = arr
        m = m._replace(**new)

        # covisibility of the new keyframe against the last 8 keyframes
        member = tk.scatter_max(torch.zeros(P, dtype=torch.bool, device=dev),
                                torch.clamp(cur_pt, 0, P - 1), cur_pt >= 0)
        n_recent = 8
        rfirst = max(kf_count - n_recent, 0)
        ro = rfirst + torch.arange(n_recent, device=dev)
        recent = torch.clamp(ro, 0, K - 1)
        rvalid = ro < kf_count
        rows = m.kf_pt_idx[recent]
        hits = member[torch.clamp(rows, 0, P - 1).long()] & (rows >= 0)
        weights = hits.sum(1).to(torch.int32) * rvalid
        order = torch.sort(-weights, stable=True).indices
        with TRACER.stage("keyframe.triangulate"):
            for t in range(n_tri_neighbors):
                nb = recent[order[t]]
                w_nb = weights[order[t]]
                tri = triangulate_with_neighbor(
                    cam, m.kf_pose[slot], m.kf_kp[slot], m.kf_desc[slot],
                    m.kf_octave[slot], m.kf_kp_valid[slot], m.kf_pt_idx[slot],
                    m.kf_pose[nb], m.kf_kp[nb], m.kf_desc[nb],
                    m.kf_octave[nb], m.kf_kp_valid[nb], m.kf_pt_idx[nb], scale2,
                )
                use = (w_nb >= mcfg.min_covis_weight) & (nb != slot)
                tri = tri._replace(good=tri.good & use)
                m, pt_count = _insert_point_rows(m, slot, nb, tri, pt_count, scale_factors)

        with TRACER.stage("keyframe.fuse"):
            fused = fuse_into_keyframe(
                cam, m.pt_pos, m.pt_valid, m.pt_desc, m.pt_min_dist, m.pt_max_dist,
                m.kf_pose[slot], m.kf_kp[slot], m.kf_desc[slot], m.kf_octave[slot],
                m.kf_kp_valid[slot], m.kf_pt_idx[slot], scale2,
            )
            kf_pt_idx = m.kf_pt_idx.clone()
            kf_pt_idx[slot] = fused
            m = m._replace(kf_pt_idx=kf_pt_idx)
        return m, kf_count + 1, pt_count, T, fused

    def step(carry: ChunkCarry, frame: Frame, ts: float, has_boxes: bool = False):
        m = carry.m
        dev = m.pt_pos.device
        K = m.kf_pose.shape[0]
        if dev not in scale2_by_device:
            s2 = scale_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor, dev)
            scale2_by_device[dev] = (s2, torch.sqrt(s2))
        scale2, scale_factors = scale2_by_device[dev]
        frame_id = carry.frame_id + 1
        kp, desc, octave, angle, valid = frame[:5]
        ref = min(carry.kf_count - 1, K - 1)

        def ref_kf():
            return tk.track_reference_kf(
                cam, m.pt_pos, m.pt_valid, carry.T_last,
                m.kf_desc[ref], m.kf_kp_valid[ref], m.kf_pt_idx[ref],
                kp, desc, octave, valid, scale2)

        TRACER.count("frames")
        with TRACER.stage("frame.motion"):
            if carry.state == OK:
                T_pred = (se3.compose(carry.velocity, carry.T_last) if carry.vel_ok
                          else carry.T_last)
                r1 = tk.track_motion_model(
                    cam, m.pt_pos, m.pt_valid, T_pred,
                    carry.last_kp, carry.last_desc, carry.last_octave,
                    carry.last_angle, carry.last_valid, carry.last_pt,
                    kp, desc, octave, angle, valid, scale2,
                    radius=cfg.matcher.search_radius_motion)
                n1 = int(r1.n_inliers)
                if n1 < tcfg.min_inliers_after_pose:
                    TRACER.count("motion_fallbacks")
                    r1 = ref_kf()
                    n1 = int(r1.n_inliers)
            else:   # LOST: retry against the reference keyframe from the last pose
                r1 = ref_kf()
                n1 = int(r1.n_inliers)
        with TRACER.stage("frame.local_map"):
            r2 = tk.track_local_map_step(
                cam, m.pt_pos, m.pt_valid, m.pt_desc, m.pt_normal,
                m.pt_min_dist, m.pt_max_dist, r1.T, r1.cur_pt,
                kp, desc, octave, valid, scale2, n_levels=cfg.orb.n_levels)
            n2 = int(r2.n_inliers) if n1 >= tcfg.min_inliers_after_pose else 0
        T, cur_pt = r2.T, r2.cur_pt
        tracked = n2 >= tcfg.min_tracked_for_ok

        # keyframe policy (Tracking::NeedNewKeyFrame; a new object landmark
        # forces a keyframe, src/Tracking.cc:1850-1897)
        frames_since = carry.frames_since_kf + 1
        peak = max(carry.peak_since_kf, n2)
        base = max(carry.ref_kf_tracked, peak, 1)
        c1 = frames_since >= tcfg.max_frames_between_kf
        c2 = n2 < ratio32 * np.float32(base)
        may_kf = (tracked and carry.allow_kf and n2 > tcfg.min_matches_ref_kf
                  and carry.kf_count < K)
        need_kf = may_kf and (c1 or c2)

        table = carry.table
        appear_new = False
        if table is not None and tracked and has_boxes and carry.allow_kf:
            with TRACER.stage("frame.objects"):
                m, table, appear_new = object_pass(m, table, T, frame, cur_pt, frame_id,
                                                   carry.obj_rng)
                if may_kf and not need_kf:
                    need_kf = bool(appear_new)     # the object pass's one readback

        kf_count, pt_count = carry.kf_count, carry.pt_count
        if need_kf:
            TRACER.count("keyframes")
            with TRACER.stage("frame.keyframe"):
                m, kf_count, pt_count, T, cur_pt = kf_branch(
                    m, kf_count, pt_count, frame, ts, frame_id, T, cur_pt,
                    scale2, scale_factors, appear_new)
        vel_ok = tracked and not need_kf and carry.state == OK
        velocity = (se3.compose(T, se3.inverse(carry.T_last)) if vel_ok
                    else torch.eye(3, 4, dtype=torch.float32, device=dev))
        state = OK if tracked else LOST
        new_carry = ChunkCarry(
            m=m,
            T_last=T if tracked else carry.T_last,
            velocity=velocity, vel_ok=vel_ok,
            last_kp=kp, last_desc=desc, last_octave=octave,
            last_angle=angle, last_valid=valid,
            last_pt=cur_pt if tracked else carry.last_pt,
            state=state,
            frames_since_kf=0 if need_kf else frames_since,
            ref_kf_tracked=n2 if need_kf else carry.ref_kf_tracked,
            peak_since_kf=n2 if need_kf else peak,
            kf_count=kf_count, pt_count=pt_count, frame_id=frame_id,
            table=table, obj_rng=carry.obj_rng, allow_kf=carry.allow_kf,
        )
        return new_carry, (T, state, n2, need_kf, kf_count, pt_count)

    return step


def make_track_chunk(cfg: SystemConfig):
    """track_chunk(carry, batch) -> (carry, ChunkOutputs): the per-frame
    step over the chunk, then (iff a keyframe was inserted) the windowed
    BA, point culling and post-BA fusion into the newest keyframe, then,
    with the object layer, the chunk-rate iForest cull."""
    step = make_chunk_step(cfg)
    cam = cfg.camera
    W = cfg.mapping.local_ba_kf_window
    Pl = cfg.capacity.local_ba_points
    psi, depth = psi_depth_for(N_OBJ_SAMPLE)

    @TRACER.staged("chunk.track")
    def track_chunk(carry: ChunkCarry, batch: FrameBatch):
        fp32_solvers()
        C = batch.kp.shape[0]
        active = (np.ones(C, bool) if batch.active is None
                  else batch.active.cpu().numpy().astype(bool))
        ts_host = batch.timestamp.cpu().numpy()
        obj_fields = (None,) * 6
        has_boxes = np.zeros(C, bool)
        if carry.table is not None and batch.boxes is not None:
            lines = (batch.lines, batch.line_valid)
            if cfg.flag.use_yaw_lines and batch.lines is None:
                dev = batch.boxes.device
                L = cfg.capacity.max_lines
                lines = (torch.zeros((C, L, 4), dtype=torch.float32, device=dev),
                         torch.zeros((C, L), dtype=torch.bool, device=dev))
            obj_fields = (batch.boxes, batch.box_class, batch.box_score, batch.box_valid, *lines)
            has_boxes = batch.box_valid.any(1).cpu().numpy()
        outs = []
        for i in range(C):
            if not active[i]:
                outs.append((carry.T_last, carry.state, 0, False,
                             carry.kf_count, carry.pt_count))
                continue
            frame = Frame(batch.kp[i], batch.desc[i], batch.octave[i], batch.angle[i],
                          batch.valid[i], *(None if x is None else x[i] for x in obj_fields))
            carry, out = step(carry, frame, float(ts_host[i]), bool(has_boxes[i]))
            outs.append(out)
        is_kf = np.array([o[3] for o in outs], bool)
        if is_kf.any():
            with TRACER.stage("chunk.window_ba"):
                m = carry.m
                scale2 = scale_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor, m.pt_pos.device)
                m = _window_ba(cam, m, carry.kf_count, W, Pl, scale2)
                m = _cull_points(m, carry.kf_count - 1)
                K = m.kf_pose.shape[0]
                newest = min(max(carry.kf_count - 1, 0), K - 1)
                if cfg.mapping.bidirectional_fuse:
                    fused = fuse_into_keyframe(
                        cam, m.pt_pos, m.pt_valid, m.pt_desc, m.pt_min_dist,
                        m.pt_max_dist, m.kf_pose[newest], m.kf_kp[newest],
                        m.kf_desc[newest], m.kf_octave[newest],
                        m.kf_kp_valid[newest], m.kf_pt_idx[newest], scale2)
                    kf_pt_idx = m.kf_pt_idx.clone()
                    kf_pt_idx[newest] = fused
                    m = m._replace(kf_pt_idx=kf_pt_idx)
                carry = carry._replace(m=m)
        if carry.table is not None and carry.allow_kf and not cfg.objects.per_frame_iforest:
            # iForest outlier cull over every object updated this chunk
            # (per frame in the C++ reference, src/Object.cc:1202-1309;
            # once per chunk in the reference package); localization mode
            # freezes the object map
            gen = carry.obj_rng
            with TRACER.stage("chunk.iforest"):
                m, table = chunk_iforest_cull(
                    cam, carry.m, carry.table, carry.T_last, carry.frame_id - C + 1,
                    lambda mask: draw_iforest(gen, mask, psi, depth), depth)
            carry = carry._replace(m=m, table=table)
        with TRACER.stage("chunk.readback"):
            T = torch.stack([o[0] for o in outs]).cpu().numpy()
            return carry, ChunkOutputs(
                T=T,
                state=np.array([o[1] for o in outs], np.int32),
                n_inliers=np.array([o[2] for o in outs], np.int32),
                is_kf=is_kf,
                kf_count=np.array([o[4] for o in outs], np.int32),
                pt_count=np.array([o[5] for o in outs], np.int32),
            )

    return track_chunk


def extract_batch(cfg: SystemConfig, images_u8: torch.Tensor, timestamps,
                  active=None, boxes=None, mesh=None) -> FrameBatch:
    """ORB front end over a chunk of raw images [C, H, W] uint8 (one FAST
    kernel launch for all pyramid levels of the whole chunk) and, with
    line-alignment yaw on and boxes given, the chunk's line segments (one
    batched call, nothing read back); ``boxes``: (boxes, class, score,
    valid) tensors [C, B, ...] or None. With a frame ``mesh`` of more than
    one rank each rank extracts its block of the frames and the features
    (and segments) are gathered in frame order (``parallel.frames``)."""
    F = cfg.capacity.max_features
    C = images_u8.shape[0]
    lo, hi = (0, C) if mesh is None else frame_block(mesh, C)
    img = images_u8[lo:hi].to(torch.float32)
    lines = {}
    if boxes is not None and cfg.flag.use_yaw_lines:
        segs, seg_valid = detect_segments(img, max_lines=cfg.capacity.max_lines)
        if mesh is not None:
            counts = [frame_block_len(mesh, C, i) for i in range(mesh.axis_size())]
            segs = all_gather_blocks(segs, mesh, None, counts)
            seg_valid = all_gather_blocks(seg_valid, mesh, None, counts)
        lines = dict(lines=segs, line_valid=seg_valid)
    feats = extract_orb(
        img, n_features=F, n_levels=cfg.orb.n_levels,
        scale_factor=cfg.orb.scale_factor,
        threshold=float(cfg.orb.fast_threshold),
        min_threshold=float(cfg.orb.fast_min_threshold),
        border=cfg.orb.edge_threshold,
    )
    if mesh is not None:
        feats = gather_features(feats, mesh, C)
    return FrameBatch(
        kp=undistort_points(cfg.camera, feats.kp), desc=feats.desc,
        octave=feats.octave, angle=feats.angle, valid=feats.valid,
        timestamp=torch.as_tensor(np.asarray(timestamps, np.float32)),
        active=active,
        **({} if boxes is None else dict(zip(("boxes", "box_class", "box_score", "box_valid"),
                                             boxes))),
        **lines,
    )


def make_extract_track(cfg: SystemConfig, track_chunk, mesh=None):
    """fn(carry, images_u8 [C, H, W], timestamps [C], active=None,
    boxes=None): raw images of one chunk (and their detector boxes)
    through ORB extraction and chunk tracking. With a frame ``mesh`` of
    more than one rank the extraction is split over the ranks by frame
    (every frame's pyramid, FAST and BRIEF run wholly on one rank, so
    its features are unchanged) and the tracking runs on every rank."""
    if mesh is not None and mesh.size < 2:
        mesh = None

    def extract_track(carry, images_u8, timestamps, active=None, boxes=None):
        with TRACER.stage("chunk.extract"):
            batch = extract_batch(cfg, images_u8, timestamps, active, boxes, mesh)
        return track_chunk(carry, batch)

    return extract_track


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------

class ChunkedTracker:
    """Bootstrap through MonoTracker, then chunked tracking with one
    pose/state readback per chunk and the between-chunk passes. Runs on
    ``cuda`` unless told otherwise (on a mesh, on the mesh's device).

    ``mesh``: a frame mesh (``parallel.frames.make_frame_mesh``) over the
    ranks of a process group, every rank running this tracker on the same
    input. With more than one rank the chunk's extraction is split over
    the ranks by frame, and the between-chunk global BA after a loop
    correction runs through the distributed dense-clique Schur solver on
    a (host, device) mesh of the same ranks (``ba_solver``)."""

    def __init__(self, cfg: SystemConfig, chunk: int = 32, device=None, mesh=None):
        self.cfg = cfg
        self.chunk = chunk
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self._ba_mesh = None
        if self.mesh is not None:
            from eao_slam_torch.parallel.dist_ba2 import make_hd_mesh

            self._ba_mesh = make_hd_mesh(2 if self.mesh.size >= 4 else 1, self.device)
        fp32_solvers()
        self.inner = MonoTracker(cfg, self.device)
        self.carry: Optional[ChunkCarry] = None
        self._track_chunk = make_track_chunk(cfg)
        self._extract_track = make_extract_track(cfg, self._track_chunk, self.mesh)
        self.records: list = []   # (timestamp, T 3x4 np or None, state)
        self.n_maintenance = 0    # cull + compact passes run
        self.n_relocalized = 0    # between-chunk relocalizations that succeeded
        # host mirrors of the carry's allocators and state, fed by each
        # chunk's readback, so the passes' early returns cost no sync
        self.kf_count_host = 0
        self.pt_count_host = 0
        self.state_host = LOST
        self.last_kf_slots: list = []  # (chunk frame index, slot) of the last chunk
        # called with (kf_remap, pt_remap) numpy arrays after every
        # cull + compact pass, so host-side per-slot state survives it
        self.compaction_listeners: list = []
        self._localization_only = False   # localization mode: the map is frozen
        # loop closing at chunk rate; both RANSACs of the between-chunk
        # passes draw from this generator (on the host, so a seed gives the
        # same draws on every device)
        self.loop_closer = LoopCloser(cfg) if cfg.tracking.enable_loop_closing else None
        self.loop_rng = torch.Generator().manual_seed(cfg.seed + 7)
        self._loop_checked = 0    # keyframes already run through detection
        self.n_object_merges = 0  # object pairs merged between chunks
        self.n_object_kills = 0   # objects deleted as false positives between chunks

    # -- bootstrap ------------------------------------------------------

    def bootstrap(self, frame: Frame, timestamp: float, gt_pose=None) -> bool:
        """Feed frames one at a time until two-view init succeeds. Returns
        True once the map exists and chunked mode is armed. ``gt_pose``:
        the frame's ground-truth T_wc [3, 4] or None (MonoTracker.track)."""
        T = self.inner.track(frame, timestamp, gt_pose=gt_pose)
        self.records.append((timestamp, None if T is None else np.asarray(T),
                             self.inner.state))
        if self.inner.state == OK:
            self._arm()
            return True
        return False

    def _arm(self):
        t = self.inner
        F = self.cfg.capacity.max_features
        lf = t.last_frame
        self.carry = ChunkCarry(
            m=t.map,
            T_last=torch.as_tensor(np.asarray(t.last_T, np.float32), device=self.device),
            velocity=torch.eye(3, 4, dtype=torch.float32, device=self.device),
            vel_ok=False,
            last_kp=lf.kp, last_desc=lf.desc, last_octave=lf.octave,
            last_angle=lf.angle, last_valid=lf.valid,
            last_pt=(t.last_pt.to(torch.int32) if t.last_pt is not None
                     else torch.full((F,), -1, dtype=torch.int32, device=self.device)),
            state=OK, frames_since_kf=0,
            ref_kf_tracked=int(t.ref_kf_tracked), peak_since_kf=0,
            kf_count=len(t.kf_slots), pt_count=int(t.n_points),
            frame_id=int(t.frame_id), allow_kf=not self._localization_only,
        )
        if self.cfg.flag.objects_enabled:
            # the reference's object pass runs only once the map exists, so
            # the table starts empty (tracker.py:410-421); the iForest draws
            # come from a host generator seeded from the config
            self.carry = self.carry._replace(
                table=empty_object_table(self.cfg.capacity.max_objects, device=self.device),
                obj_rng=torch.Generator().manual_seed(self.cfg.objects.iforest_seed))
        self.kf_count_host = len(t.kf_slots)
        self.pt_count_host = int(t.n_points)
        self.state_host = OK

    # -- mode switches --------------------------------------------------

    def reset(self):
        """Clear the map and the carry and restart from scratch
        (System::Reset): a new bootstrap tracker, no records, a new loop
        closer."""
        self.inner = MonoTracker(self.cfg, self.device)
        self.carry = None
        self.records = []
        self.last_kf_slots = []
        self.n_maintenance = 0
        self.kf_count_host = 0
        self.pt_count_host = 0
        self.state_host = LOST
        self._loop_checked = 0
        if self.loop_closer is not None:
            self.loop_closer = LoopCloser(self.cfg)

    def set_localization_mode(self, on: bool):
        """Freeze or unfreeze the map (mbOnlyTracking,
        src/Tracking.cc:245-257): with the carry's allow_kf False the chunk
        inserts no keyframes, runs no BA or culling and leaves the object
        map alone; no merge or maintenance between chunks."""
        self._localization_only = bool(on)
        self.inner.set_localization_mode(on)
        if self.carry is not None:
            self.carry = self.carry._replace(allow_kf=not on)

    # -- chunked tracking ------------------------------------------------

    def track_batch(self, batch: FrameBatch) -> ChunkOutputs:
        """Track one chunk of pre-extracted frames (the feature-level
        seam); partial chunks mark their live prefix in ``batch.active``."""
        if self.carry is None:
            raise RuntimeError("call bootstrap() until it returns True")
        TRACER.next_chunk()
        batch = FrameBatch(*(x.to(self.device) if torch.is_tensor(x) else x for x in batch))
        kf_before = self.kf_count_host
        self.carry, outs = self._track_chunk(self.carry, batch)
        ts = batch.timestamp.cpu().numpy()
        if batch.active is not None:
            ts = ts[: int(batch.active.sum())]
        return self._after_chunk(outs, ts, kf_before)

    def track_images(self, images_u8, timestamps, boxes=None, box_class=None,
                     box_score=None, box_valid=None) -> ChunkOutputs:
        """Up to `chunk` raw grayscale images through ORB extraction and
        chunk tracking, with their detector boxes ([n, B, ...] arrays; none
        given means no detections). Short batches are padded with the last
        image and masked inactive."""
        kf_before = self.kf_count_host
        outs = self._dispatch_images(images_u8, timestamps, boxes, box_class, box_score,
                                     box_valid)
        return self._after_chunk(outs, np.asarray(timestamps, np.float32), kf_before)

    def _dispatch_images(self, images_u8, timestamps, boxes=None, box_class=None,
                         box_score=None, box_valid=None) -> ChunkOutputs:
        """``track_images`` without the records and the between-chunk
        passes (a multi-sequence engine defers those)."""
        if self.carry is None:
            raise RuntimeError("call bootstrap() until it returns True")
        TRACER.next_chunk()
        C = self.chunk
        imgs = np.asarray(images_u8)
        n = int(imgs.shape[0])
        if not 0 < n <= C:
            raise ValueError(f"batch of {n} images vs chunk={C}")

        def pad(a):
            a = np.asarray(a)
            return a if n == C else np.concatenate([a, np.repeat(a[-1:], C - n, 0)])

        ts = pad(np.asarray(timestamps, np.float32))
        imgs = pad(imgs)
        active = None
        if n < C:
            act = np.zeros((C,), bool)
            act[:n] = True
            active = torch.as_tensor(act)
        box_t = None
        if self.cfg.flag.objects_enabled:
            if boxes is None:
                boxes, box_class, box_score, box_valid = (
                    np.broadcast_to(x, (n,) + x.shape) for x in empty_boxes(self.cfg))
            box_t = tuple(torch.as_tensor(pad(x), device=self.device)
                          for x in (boxes, box_class, box_score, box_valid))
        self.carry, outs = self._extract_track(
            self.carry, torch.as_tensor(imgs, device=self.device), ts, active, box_t)
        return outs

    def _after_chunk(self, outs: ChunkOutputs, ts, kf_before: int) -> ChunkOutputs:
        self._record_chunk(outs, ts, kf_before)
        self._between_chunk_passes()
        return outs

    @TRACER.staged("chunk.record")
    def _record_chunk(self, outs: ChunkOutputs, ts, kf_before: int) -> ChunkOutputs:
        """Record the live frames' poses, this chunk's keyframe slots (the
        monotonic allocator: kf_before + running keyframe count) and the
        host mirrors of the allocators and the tracking state."""
        self.last_kf_slots = []
        for i in range(len(ts)):
            ok = outs.state[i] == OK
            self.records.append((float(ts[i]), outs.T[i] if ok else None, int(outs.state[i])))
            if outs.is_kf[i]:
                self.last_kf_slots.append((i, kf_before + len(self.last_kf_slots)))
        last = len(ts) - 1
        self.kf_count_host = int(outs.kf_count[last])
        self.pt_count_host = int(outs.pt_count[last])
        self.state_host = int(outs.state[last])
        return outs

    def _between_chunk_passes(self):
        self._maybe_merge_objects()
        self._maybe_maintain()
        self._maybe_close_loops()
        self._maybe_relocalize()

    @TRACER.staged("pass.merge_objects")
    def _maybe_merge_objects(self):
        """Object merge and overlap resolution between chunks
        (MergePotentialAssObjs + DealTwoOverlapObjs,
        src/LocalMapping.cc:799-882): one readback of the pair statistics,
        the decisions on the host, the rewrites on the device."""
        c = self.carry
        if c is None or c.table is None or self._localization_only:
            return
        m, table, merged, killed = run_merge_pass(c.m, c.table)
        self.carry = c._replace(m=m, table=table)
        self.n_object_merges += merged
        self.n_object_kills += killed

    @TRACER.staged("pass.maintain")
    def _maybe_maintain(self):
        """When the monotonic allocators near capacity (within max(8,
        chunk / 2) keyframes or 3 x max_features points), cull redundant
        keyframes and dead points and compact both tables, so long
        sequences run at fixed capacity. Everything that holds a slot is
        remapped: the carry's last_pt, last_kf_slots, the loop closer's
        signatures and streaks, and the compaction listeners."""
        if self._localization_only:
            return
        c = self.carry
        K = c.m.kf_pose.shape[0]
        P = c.m.pt_pos.shape[0]
        kf_headroom = max(8, self.chunk // 2)
        pt_headroom = 3 * self.cfg.capacity.max_features
        if (self.kf_count_host <= K - kf_headroom
                and self.pt_count_host <= P - pt_headroom):
            return
        res = cull_and_compact(c.m, c.kf_count, c.pt_count, n_levels=self.cfg.orb.n_levels,
                               redundancy=self.cfg.mapping.kf_cull_redundancy)
        last_pt = torch.where(c.last_pt >= 0,
                              res.pt_remap[torch.clamp(c.last_pt, 0, P - 1).long()], -1)
        self.carry = c._replace(m=res.m, kf_count=res.kf_count, pt_count=res.pt_count,
                                last_pt=last_pt)
        self.kf_count_host = res.kf_count
        self.pt_count_host = res.pt_count
        self.n_maintenance += 1
        kf_remap = res.kf_remap.cpu().numpy()
        pt_remap = res.pt_remap.cpu().numpy()
        self.last_kf_slots = [(i, int(kf_remap[s])) for i, s in self.last_kf_slots
                              if kf_remap[s] >= 0]
        if self.loop_closer is not None:
            self.loop_closer.remap_slots(kf_remap)
            self._loop_checked = int((kf_remap[:self._loop_checked] >= 0).sum())
        for cb in self.compaction_listeners:
            cb(kf_remap, pt_remap)

    @TRACER.staged("pass.relocalize")
    def _maybe_relocalize(self):
        """Tracking::Relocalization between chunks: if a chunk ends LOST,
        score the last frame's descriptors against every keyframe's
        signature, brute-match the best five candidates and recover the
        pose with EPnP RANSAC; on success the carry re-arms in OK state.
        (The in-scan LOST handler only retries the reference keyframe from
        the last pose.)"""
        c = self.carry
        if c is None or self.state_host != LOST:
            return
        n = self.kf_count_host
        if n == 0:
            return
        m = c.m
        P = m.pt_pos.shape[0]
        F = c.last_kp.shape[0]
        n_lv = self.cfg.orb.n_levels
        scale2 = scale_sigma2(n_lv, self.cfg.orb.scale_factor, self.device)
        sig_q = kf_signature(c.last_desc, c.last_valid)
        scores = (kf_signatures(m.kf_desc[:n], m.kf_kp_valid[:n]) @ sig_q).cpu().numpy()
        scores[~m.kf_valid[:n].cpu().numpy()] = -1.0
        for slot in np.argsort(-scores)[:5]:
            slot = int(slot)
            if scores[slot] <= 0:
                break
            pt_kf = m.kf_pt_idx[slot]
            q_valid = m.kf_kp_valid[slot] & (pt_kf >= 0)
            idx, _, ok = matching.search_brute(m.kf_desc[slot], q_valid, c.last_desc,
                                               c.last_valid, max_dist=matching.TH_LOW,
                                               ratio=0.75)
            if int(ok.sum()) < 15:
                continue
            il = idx.long()
            Xw = m.pt_pos[torch.clamp(pt_kf, 0, P - 1).long()]
            inv_s2 = 1.0 / scale2[torch.clamp(c.last_octave[il], 0, n_lv - 1).long()]
            pnp = pnp_ransac(self.cfg.camera, Xw, c.last_kp[il], ok, inv_s2,
                             generator=self.loop_rng)
            if not bool(pnp.success):
                continue
            keep = ok & pnp.inliers
            last_pt = tk.scatter_max(torch.full((F,), -1, dtype=torch.int32, device=self.device),
                                     il, torch.where(keep, pt_kf, -1))
            self.carry = c._replace(
                T_last=pnp.T.to(torch.float32),
                velocity=torch.eye(3, 4, dtype=torch.float32, device=self.device),
                vel_ok=False, last_pt=last_pt, state=OK)
            self.state_host = OK
            self.n_relocalized += 1
            return

    @TRACER.staged("pass.close_loops")
    def _maybe_close_loops(self):
        """Loop detection (+ correction on success) for every keyframe the
        last chunk inserted, at chunk rate. The backlog's signatures come
        back in one readback; on success the corrected map is written back
        into the carry and the motion model rebases on the newest
        keyframe's corrected pose."""
        if self.loop_closer is None or self.carry is None:
            return
        n = self.kf_count_host
        first = self._loop_checked
        if n <= first:
            return
        view = _LoopView(self)
        m = self.carry.m
        sig_batch = kf_signatures(m.kf_desc[first:n], m.kf_kp_valid[first:n]).cpu().numpy()
        closed = False
        for order in range(first, n):
            if self.loop_closer.on_keyframe(view, order, signature=sig_batch[order - first],
                                            order=order):
                closed = True
        self._loop_checked = n
        if closed:
            newest = n - 1
            kf_pt = torch.as_tensor(view.kf_pt_host, device=self.device)
            self.carry = self.carry._replace(
                m=view.map._replace(kf_pt_idx=kf_pt,
                                    pt_valid=torch.as_tensor(view.pt_valid_host,
                                                             device=self.device)),
                T_last=view.map.kf_pose[newest].clone(),
                velocity=torch.eye(3, 4, dtype=torch.float32, device=self.device),
                vel_ok=False,
                last_pt=kf_pt[newest].clone(),
            )

    # -- views and exports ------------------------------------------------

    @property
    def ba_solver(self):
        """(cam, BAProblem) -> BAResult for the between-chunk global BA
        (loop correction): None on one rank (the single-device 5 + 10
        schedule, ``solvers.ba.local_ba``); over a mesh, the same schedule
        through the distributed dense-clique solver
        (``parallel.dist_ba2``)."""
        if self._ba_mesh is None:
            return None
        from eao_slam_torch.parallel.dist_ba2 import distributed_bundle_adjust_v2

        ba_mesh = self._ba_mesh

        def dist_local_ba(cam, prob):
            res1 = distributed_bundle_adjust_v2(cam, prob, ba_mesh, iters=5)
            prob2 = prob._replace(poses=res1.poses, points=res1.points,
                                  obs_valid=prob.obs_valid & res1.obs_inlier)
            return distributed_bundle_adjust_v2(cam, prob2, ba_mesh, iters=10)

        return dist_local_ba

    @property
    def armed(self) -> bool:
        return self.carry is not None

    @property
    def state(self) -> int:
        return self.state_host if self.armed else self.inner.state

    @property
    def map(self) -> MapState:
        return self.carry.m if self.armed else self.inner.map

    @property
    def kf_slots(self) -> list:
        """Keyframe slots in insertion order: the bootstrap's, then
        range(kf_count) once armed (the allocator is monotonic)."""
        return list(range(self.kf_count_host)) if self.armed else list(self.inner.kf_slots)

    @property
    def kf_valid_host(self) -> np.ndarray:
        return self.map.kf_valid.cpu().numpy()

    @property
    def kf_pt_host(self) -> np.ndarray:
        return self.map.kf_pt_idx.cpu().numpy()

    @property
    def obj_table(self) -> Optional[ObjectTable]:
        """The object landmark table (None in geometry mode or before the
        tracker is armed)."""
        return self.carry.table if self.armed else None

    def frame_trajectory(self):
        recs = [(t, T) for t, T, s in self.records if T is not None]
        ts = np.array([t for t, _ in recs])
        Ts = np.stack([T for _, T in recs]) if recs else np.zeros((0, 3, 4))
        return ts, Ts

    def keyframe_trajectory(self):
        m = self.map
        kf_valid = m.kf_valid.cpu().numpy()
        ts = m.kf_timestamp.cpu().numpy()[kf_valid]
        Ts = m.kf_pose.cpu().numpy()[kf_valid]
        order = np.argsort(ts)
        return ts[order], Ts[order]


class _LoopView:
    """MonoTracker-shaped adapter over a ChunkCarry, so that the LoopCloser
    runs between chunks. The monotonic allocator makes slot == insertion
    order, so kf_slots is range(kf_count). Changes (map, observation rows,
    point validity) accumulate on the view; ``_maybe_close_loops`` folds
    them back into the carry."""

    def __init__(self, chunked: ChunkedTracker):
        m = chunked.carry.m
        self.cfg = chunked.cfg
        self.cam = chunked.cfg.camera
        self.map = m
        self.scale2_np = chunked.inner.scale2_np
        self.generator = chunked.loop_rng
        self.kf_slots = list(range(chunked.kf_count_host))
        self.kf_valid_host = m.kf_valid.cpu().numpy()
        self.kf_pt_host = m.kf_pt_idx.cpu().numpy().copy()
        self.pt_valid_host = m.pt_valid.cpu().numpy().copy()
        self._covis_cache = None
        # the global BA's solver rides through the view (None: single device)
        self.ba_solver = chunked.ba_solver

    def covis_weights(self, slot: int) -> np.ndarray:
        """Row of the covisibility matrix: one cached product per pass."""
        if self._covis_cache is None:
            m = self.map
            self._covis_cache = covisibility(m.kf_pt_idx, m.kf_kp_valid, m.kf_valid,
                                             m.pt_pos.shape[0]).cpu().numpy().astype(np.int64)
        return self._covis_cache[slot]

    def invalidate_covis(self) -> None:
        self._covis_cache = None

    def _apply_ba(self, ba):
        m = self.map
        dev = m.pt_pos.device
        ws = torch.as_tensor(ba.kf_slots, dtype=torch.int64, device=dev)
        kf_pose = m.kf_pose.clone()
        kf_pose[ws] = ba.poses
        keep = ba.pt_slots >= 0
        pt_pos = m.pt_pos.clone()
        pt_pos[torch.as_tensor(ba.pt_slots[keep], device=dev)] = \
            ba.points[torch.as_tensor(keep, device=dev)]
        m = m._replace(kf_pose=kf_pose, pt_pos=pt_pos)
        drop = ba.drop_obs
        if drop.any():
            new_pt = self.kf_pt_host[ba.kf_slots]
            new_pt[drop] = -1
            self.kf_pt_host[ba.kf_slots] = new_pt
            kf_pt_idx = m.kf_pt_idx.clone()
            kf_pt_idx[ws] = torch.as_tensor(new_pt, device=dev)
            m = m._replace(kf_pt_idx=kf_pt_idx)
        self.map = m


def batch_from_frames(frames, timestamps) -> FrameBatch:
    """Stack a list of Frame (features, boxes, lines) into one chunk."""
    return FrameBatch(
        timestamp=torch.as_tensor(np.asarray(timestamps, np.float32)),
        **{f: torch.stack([getattr(fr, f) for fr in frames]) for f in Frame._fields
           if getattr(frames[0], f) is not None})
