"""Ensemble object data association, batched over detections and objects.

The reference runs a sequential four-stage cascade per 2D detection
against every map object (Object_2D::ObjectDataAssociation,
src/Object.cc:162-710): IoU against the motion-predicted box, Wilcoxon
rank-sum over member points, IoU against the projected member box, and a
per-axis t-test against the centroid history; then DataAssociateUpdate
(src/Object.cc:1313-1554: gated point insertion, historical-point culling),
new-object creation and the iForest outlier cull (src/Object.cc:1202-1309).

As in the reference package: every (detection, object) score is computed
at once as [B, J] tensors (``compute_detection_stats``), the cascade
resolves over them, and ``apply_frame_update`` applies all updates
batched. Targets of one frame are disjoint (the resolver guarantees it),
so the table's float sums are order-free. Both trackers resolve on the
device (``objects/resolve.py``), where the reference's interactive
``ObjectUpdater`` replays the cascade on the host: its tests show the two
resolvers equal. The interactive tracker's ``ObjectUpdater`` runs the
iForest cull per frame.

Trouble spots, handled as in the reference:
- member and detection subsamples rank ``1 + h`` with a hash of only 997
  or 1009 distinct values, so ties are common; ``jax.lax.top_k`` returns
  the lower index first, and ``_top_k`` is a stable descending sort that
  does the same (the iForest subsample indexes into that order);
- the point-membership scatter can see one point from two features; the
  last write in feature order wins, as on the reference's CPU backend
  (``set_last_wins`` after a stable sort).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera, project
from eao_slam_torch.objects import boxes as boxops
from eao_slam_torch.objects import stats
from eao_slam_torch.config import SystemConfig
from eao_slam_torch.objects.iforest import IForestDraws, anomaly_scores, draw_iforest, psi_depth_for
from eao_slam_torch.objects.state import ObjectTable, yaw_rotation
from eao_slam_torch.runtime.map_state import MapState
from eao_slam_torch.runtime.tracking_kernels import scatter_max, set_last_wins, set_rows_drop

# iForest class gates (src/Object.cc:1206-1212)
IFOREST_SKIP_CLASSES = (75, 64, 65)
IFOREST_TV_CLASS = 62
# scale-gated insertion classes (src/Object.cc:1462: chair 56, teddy 77)
SCALE_GATE_CLASSES = (56, 77)

N_OBJ_SAMPLE = 192     # member-point subsample per object for pair stats
N_DET_SAMPLE = 128     # detection-point subsample
N_IFOREST_SAMPLE = 512  # member cap of the iForest pass


class FrameDetections(NamedTuple):
    """Stage scores and per-detection data of one frame."""
    det_valid: torch.Tensor      # [B] after hygiene, box plot, min points
    det_center: torch.Tensor     # [B, 3]
    det_npts: torch.Tensor       # [B] i32
    det_pt_mask: torch.Tensor    # [B, F] final member mask
    feat_rect: torch.Tensor      # [B, 4]
    iou_pred: torch.Tensor       # [B, J] stage 1 IoU vs predicted rect
    iou_thresh: torch.Tensor     # [J] 0.5 or 0.6
    np_pass: torch.Tensor        # [B, J] stage 2 rank-sum verdict
    np_m_ok: torch.Tensor        # [B] m >= 20
    np_n_ok: torch.Tensor        # [J] n >= 20
    proj_iou: torch.Tensor       # [B, J] stage 3 IoU vs projected rect
    t_vals: torch.Tensor         # [B, J, 3] stage 4 per-axis t
    sanity_iou: torch.Tensor     # [B, J]
    sanity_former: torch.Tensor  # [B, J]
    class_ok: torch.Tensor       # [B, J]
    obj_sub_idx: torch.Tensor    # [J, No] member subsample point ids
    obj_sub_mask: torch.Tensor   # [J, No]


def subsample_hash(n: int, modulus: int, device) -> torch.Tensor:
    """[n] float32 deterministic tiebreak in [0, 1): (i * 2654435761 mod
    2^32) mod ``modulus``, over ``modulus``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return (((i * 2654435761) % (1 << 32)) % modulus).to(torch.float32) / float(modulus)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: largest first, ties in index
    order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _members(pt_object_id, pt_valid, J: int) -> torch.Tensor:
    """[J, P] membership of each object slot."""
    return (pt_object_id[None, :] == torch.arange(J, device=pt_object_id.device)[:, None]) \
        & pt_valid[None, :]


def compute_detection_stats(cam: Camera, pt_pos, pt_valid, pt_object_id, table: ObjectTable,
                            T_cw, kp, cur_pt, bxs, cls, score, bvalid,
                            frame_id: int) -> FrameDetections:
    P = pt_pos.shape[0]
    F = kp.shape[0]
    B = bxs.shape[0]
    J = table.capacity
    W, H = float(cam.width), float(cam.height)
    dev = pt_pos.device

    # detection membership: tracked features inside each box
    det_mask = boxops.points_in_box(kp, bxs) & (cur_pt >= 0)[None, :] & bvalid[:, None]
    Xw_feat = pt_pos[torch.clamp(cur_pt, 0, P - 1).long()]              # [F, 3]
    xc_feat = se3.apply(T_cw, Xw_feat)
    det_mask = stats.boxplot_depth_inliers(xc_feat[None, :, 2].expand(B, F), det_mask)
    det_npts = det_mask.sum(1).to(torch.int32)
    det_center = torch.where(det_mask[..., None], Xw_feat[None], 0.0).sum(1) \
        / torch.clamp(det_npts, min=1)[:, None]
    feat_rect = boxops.bbox_of_points(kp[None].expand(B, F, 2), det_mask, W, H)
    det_valid = boxops.box_hygiene(bxs, cls, score, bvalid, det_npts, W, H) & (det_npts >= 5)

    # object member subsample [J, No]
    member = _members(pt_object_id, pt_valid, J)
    h = subsample_hash(P, 997, dev)
    top_vals, obj_sub_idx = _top_k(torch.where(member, 1.0 + h[None, :], 0.0), N_OBJ_SAMPLE)
    obj_sub_mask = top_vals > 0.0
    obj_sub_pos = pt_pos[obj_sub_idx]                                   # [J, No, 3]
    obj_n = member.sum(1)

    # projected rect per object
    xc_obj = se3.apply(T_cw, obj_sub_pos)
    proj_rect = boxops.bbox_of_points(project(cam, xc_obj), obj_sub_mask & (xc_obj[..., 2] > 0.05),
                                      W, H)

    # stage 1: motion-predicted rect and IoU
    two_frames = table.last_last_frame == frame_id - 2
    lr, llr = table.last_rect, table.last_last_rect
    px0 = torch.clamp(lr[:, 0] * 2 - llr[:, 0], min=0.0)
    py0 = torch.clamp(lr[:, 1] * 2 - llr[:, 1], min=0.0)
    px1 = (lr[:, 0] + lr[:, 2]) * 2 - (llr[:, 0] + llr[:, 2])
    py1 = (lr[:, 1] + lr[:, 3]) * 2 - (llr[:, 1] + llr[:, 3])
    pred_rect = torch.where(two_frames[:, None],
                            torch.stack([px0, py0, px1 - px0, py1 - py0], 1), lr)
    seen_last = table.last_frame == frame_id - 1
    iou_pred = boxops.iou(bxs, pred_rect) * seen_last[None, :]
    iou_thresh = torch.where(two_frames & seen_last, 0.6, 0.5)

    # stage 2: rank-sum over detection points x object subsample
    dvals, det_sub_idx = _top_k(torch.where(det_mask, 1.0 + h[None, :F], 0.0), N_DET_SAMPLE)
    det_sub_pos = Xw_feat[det_sub_idx]                                  # [B, Nd, 3]
    np_pass = stats.rank_sum_all_axes_pass(
        det_sub_pos[:, None], (dvals > 0.0)[:, None],
        obj_sub_pos[None].expand(B, J, N_OBJ_SAMPLE, 3),
        obj_sub_mask[None].expand(B, J, N_OBJ_SAMPLE))                  # [B, J]

    # stage 3: projected IoU, box and feature-rect variants
    proj_iou = torch.maximum(boxops.iou(bxs, proj_rect), boxops.iou(feat_rect, proj_rect))

    # stage 4: t statistics
    t_vals = stats.t_statistic_center(
        det_center[:, None, :], table.center[None], table.center_std[None],
        torch.clamp(table.n_obs, min=1)[None].to(torch.float32))

    # sanity gate inputs (DataAssociateUpdate step 1): the union of the
    # detection points' rect and the object's projected rect
    det_rect_pts = boxops.bbox_of_points(project(cam, xc_feat)[None].expand(B, F, 2), det_mask,
                                         W, H)
    d, p = det_rect_pts[:, None, :], proj_rect[None, :, :]
    ux0 = torch.minimum(d[..., 0], p[..., 0])
    uy0 = torch.minimum(d[..., 1], p[..., 1])
    ux1 = torch.maximum(d[..., 0] + d[..., 2], p[..., 0] + p[..., 2])
    uy1 = torch.maximum(d[..., 1] + d[..., 3], p[..., 1] + p[..., 3])
    union_rect = torch.stack([ux0, uy0, ux1 - ux0, uy1 - uy0], -1)       # [B, J, 4]

    return FrameDetections(
        det_valid=det_valid, det_center=det_center, det_npts=det_npts, det_pt_mask=det_mask,
        feat_rect=feat_rect, iou_pred=iou_pred, iou_thresh=iou_thresh, np_pass=np_pass,
        np_m_ok=det_npts >= 20, np_n_ok=obj_n >= 20, proj_iou=proj_iou, t_vals=t_vals,
        sanity_iou=boxops.iou_elem(union_rect, proj_rect[None]),
        sanity_former=boxops.overlap_former_elem(union_rect, bxs[:, None, :]),
        class_ok=cls[:, None] == table.cls[None, :],
        obj_sub_idx=obj_sub_idx, obj_sub_mask=obj_sub_mask)


def member_stats(cam: Camera, pt_pos, pt_valid, pt_object_id, table: ObjectTable, T_cw, h):
    """Member-derived object statistics from the point tables: centroid and
    std (ComputeMeanAndStandard, src/Object.cc:967; an object without
    members keeps its centre), the object-frame AABB and r_max, and the
    projected rect for the next frame. h: [P] subsample hash."""
    J = table.capacity
    member = _members(pt_object_id, pt_valid, J)
    mw = member.to(torch.float32)
    n_mem = mw.sum(1)
    has_mem = n_mem > 0
    denom = torch.clamp(n_mem, min=1.0)[:, None]
    center = torch.where(has_mem[:, None], (mw @ pt_pos) / denom, table.center)
    std = torch.sqrt(torch.clamp((mw @ pt_pos ** 2) / denom - center ** 2, min=1e-12))

    x_obj = torch.einsum("jba,jpb->jpa", yaw_rotation(table.yaw),
                         pt_pos[None, :, :] - center[:, None, :])
    big = 1e9
    zero = torch.zeros_like(center)
    cub_min = torch.where(has_mem[:, None],
                          torch.where(member[..., None], x_obj, big).amin(1), zero)
    cub_max = torch.where(has_mem[:, None],
                          torch.where(member[..., None], x_obj, -big).amax(1), zero)
    r_max = torch.linalg.norm(torch.maximum(cub_min.abs(), cub_max.abs()), dim=-1)

    top_v, sub = _top_k(torch.where(member, 1.0 + h[None, :], 0.0), N_OBJ_SAMPLE)
    xc = se3.apply(T_cw, pt_pos[sub])
    proj_rect = boxops.bbox_of_points(project(cam, xc), (top_v > 0.0) & (xc[..., 2] > 0.05),
                                      float(cam.width), float(cam.height))
    return center, std, cub_min, cub_max, r_max, proj_rect, has_mem


def _class_in(cls: torch.Tensor, classes) -> torch.Tensor:
    out = torch.zeros_like(cls, dtype=torch.bool)
    for c in classes:
        out = out | (cls == c)
    return out


def _index_add_drop(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].add(val, mode="drop")`` for an index equal to len(arr)
    marking a dropped row."""
    ext = torch.cat([arr, arr[:1]], 0)
    return ext.index_add(0, idx.long(), val.to(arr.dtype))[: arr.shape[0]]


def apply_frame_update(cam: Camera, m: MapState, table: ObjectTable, det: FrameDetections,
                       assoc, new_slots, bxs, cls, T_cw, kp, cur_pt, frame_id: int,
                       draw: Callable[[torch.Tensor], IForestDraws] = None,
                       depth: int = 7, run_iforest: bool = False):
    """Batched DataAssociateUpdate + InitObjMap + optional iForest + stats
    refresh (src/Object.cc:1313-1554, 1202-1309, 967-1198). ``assoc`` /
    ``new_slots`` [B]: the resolver's object slot or -1 per detection.
    With ``run_iforest`` the outlier cull runs on the updated objects (the
    reference's per-frame pacing), its draws from ``draw(mask)``; the
    chunked tracker runs ``chunk_iforest_cull`` once per chunk instead."""
    P = m.pt_pos.shape[0]
    J = table.capacity
    dev = m.pt_pos.device

    target = torch.where(assoc >= 0, assoc, new_slots)
    is_new = (new_slots >= 0) & (assoc < 0)
    active = target >= 0
    tj = torch.clamp(target, 0, J - 1).long()

    # 1. gated point-membership insertion
    owned = det.det_pt_mask & active[:, None]                          # [B, F]
    owner_b = torch.argmax(owned.to(torch.uint8), 0)                   # first detection
    feat_obj = torch.where(owned.any(0), target[owner_b], -1).to(torch.int32)
    p_of_f = torch.clamp(cur_pt, 0, P - 1).long()
    Xf = m.pt_pos[p_of_f]
    fj = torch.clamp(feat_obj, 0, J - 1).long()
    centers = table.center[fj]
    dist = torch.linalg.norm(Xf - centers, dim=-1)
    th_dist = torch.where(table.n_obs[fj] > 5, 0.9, 1.0)
    obj_isnew = scatter_max(torch.zeros(J, dtype=torch.bool, device=dev), tj, is_new)
    dist_ok = (dist <= th_dist * torch.clamp(table.r_max[fj], min=1e-6)) | obj_isnew[fj]
    # scale gate for chair / teddy after 10 observations (src/Object.cc:1462-1469)
    x_obj = torch.einsum("fba,fb->fa", yaw_rotation(table.yaw[fj]), Xf - centers)
    half = 0.5 * (table.cub_max[fj] - table.cub_min[fj])
    scale_applies = _class_in(table.cls[fj], SCALE_GATE_CLASSES) & (table.n_obs[fj] >= 10)
    scale_ok = ~scale_applies | (x_obj.abs() <= 1.2 * torch.clamp(half, min=1e-6)).all(-1)
    insert = (feat_obj >= 0) & (cur_pt >= 0) & ((dist_ok & scale_ok) | obj_isnew[fj])

    same = m.pt_object_id[p_of_f] == feat_obj
    upd_votes = torch.where(same, m.pt_obj_votes[p_of_f] + 1, 1).to(torch.int32)
    # one point may be the match of two features: the last in feature
    # order wins
    order = torch.sort(torch.where(insert, p_of_f, P), stable=True)
    pt_object_id = set_last_wins(m.pt_object_id, order.values, feat_obj[order.indices])
    pt_obj_votes = set_last_wins(m.pt_obj_votes, order.values, upd_votes[order.indices])

    # 2. historical-point culling (DataAssociateUpdate step 4): members of
    # an object associated this frame that project inside the image but
    # outside its box, with <= 8 votes, leave it
    margin_ok = ((bxs[:, 0] > 25) & (bxs[:, 1] > 25)
                 & (bxs[:, 0] + bxs[:, 2] < cam.width - 25)
                 & (bxs[:, 1] + bxs[:, 3] < cam.height - 25)) & active & ~is_new
    cull_idx = torch.where(margin_ok, tj, J)
    obj_box = set_rows_drop(torch.zeros((J, 4), device=dev), cull_idx, bxs)
    obj_cullable = set_rows_drop(torch.zeros(J, dtype=torch.bool, device=dev), cull_idx, True)
    xc_all = se3.apply(T_cw, m.pt_pos)
    uv_all = project(cam, xc_all)
    in_img = (xc_all[:, 2] > 0.05) & (uv_all[:, 0] >= 0) & (uv_all[:, 0] < cam.width) \
        & (uv_all[:, 1] >= 0) & (uv_all[:, 1] < cam.height)
    oj = torch.clamp(pt_object_id, 0, J - 1).long()
    bx = obj_box[oj]
    in_box = (uv_all[:, 0] >= bx[:, 0]) & (uv_all[:, 0] <= bx[:, 0] + bx[:, 2]) \
        & (uv_all[:, 1] >= bx[:, 1]) & (uv_all[:, 1] <= bx[:, 1] + bx[:, 3])
    evict = (pt_object_id >= 0) & obj_cullable[oj] & in_img & ~in_box \
        & (pt_obj_votes <= 8) & m.pt_valid
    pt_object_id = torch.where(evict, -1, pt_object_id)
    pt_obj_votes = torch.where(evict, 0, pt_obj_votes)

    # 3. iForest on the updated objects
    h = subsample_hash(P, 1009, dev)
    if run_iforest:
        upd_member = (pt_object_id[None, :] == tj[:, None]) & m.pt_valid[None, :] \
            & active[:, None]
        pt_object_id, pt_obj_votes = _iforest_score_and_evict(
            m.pt_pos, pt_object_id, pt_obj_votes, upd_member, cls, active, h, draw, depth)

    # 4. table bookkeeping and stats refresh
    safe_t = torch.where(active, tj, J)
    new_t = torch.where(is_new, tj, J)
    valid = scatter_max(table.valid, tj, active)
    cls_tab = set_rows_drop(table.cls, new_t, cls)
    n_obs = _index_add_drop(table.n_obs, safe_t, active.to(torch.int32))
    last_last_frame = set_rows_drop(table.last_last_frame, safe_t, table.last_frame[tj])
    last_frame = set_rows_drop(table.last_frame, safe_t,
                               torch.full_like(safe_t, frame_id, dtype=torch.int32))
    last_last_rect = set_rows_drop(table.last_last_rect, safe_t, table.last_rect[tj])
    last_rect = set_rows_drop(table.last_rect, safe_t, bxs)
    act_c = torch.where(active[:, None], det.det_center, 0.0)
    cent_sum = _index_add_drop(table.cent_sum, safe_t, act_c)
    cent_sumsq = _index_add_drop(table.cent_sumsq, safe_t, act_c ** 2)
    n_f = torch.clamp(n_obs, min=1).to(torch.float32)[:, None]
    center_std = torch.sqrt(torch.clamp(cent_sumsq / n_f - (cent_sum / n_f) ** 2, min=1e-12))

    center, std, cub_min, cub_max, r_max, proj_rect, has_mem = member_stats(
        cam, m.pt_pos, m.pt_valid, pt_object_id, table, T_cw, h)

    # co-occurrence (src/Tracking.cc:1619-1647)
    not_eye = ~torch.eye(J, dtype=torch.bool, device=dev)
    seen_now = scatter_max(torch.zeros(J, dtype=torch.bool, device=dev), tj, active)
    co_occur = table.co_occur + (seen_now[:, None] & seen_now[None, :] & not_eye).to(torch.int32)

    # object culling (src/Tracking.cc:1580-1617): young objects unseen for
    # 30 frames die (df < 5), or die on 3D overlap (5 <= df < 10); an
    # object whose members were all culled dies (src/Object.cc:1046-1051)
    unseen = last_frame < frame_id - 30
    w_min, w_max = center + cub_min, center + cub_max
    ov = ((w_min[:, None, :] <= w_max[None, :, :]) & (w_max[:, None, :] >= w_min[None, :, :])).all(-1) \
        & valid[:, None] & valid[None, :] & not_eye
    bad = table.bad | (valid & unseen & (n_obs < 5)) \
        | (valid & unseen & (n_obs >= 5) & (n_obs < 10) & ov.any(1)) | (valid & ~has_mem)

    table = table._replace(
        valid=valid, bad=bad, cls=cls_tab, n_obs=n_obs,
        last_frame=last_frame, last_last_frame=last_last_frame,
        last_rect=last_rect, last_last_rect=last_last_rect, proj_rect=proj_rect,
        center=center, std=std, cent_sum=cent_sum, cent_sumsq=cent_sumsq,
        center_std=center_std, r_max=r_max, cub_min=cub_min, cub_max=cub_max,
        co_occur=co_occur)
    return m._replace(pt_object_id=pt_object_id, pt_obj_votes=pt_obj_votes), table


def _iforest_score_and_evict(pt_pos, pt_object_id, pt_obj_votes, member, cls_vec, extra_gate,
                             h, draw, depth):
    """Hash subsample -> isolation-forest score -> threshold eviction, the
    shared block of the per-frame and chunk-rate passes
    (IsolationForestDeleteOutliers, src/Object.cc:1202-1309). member:
    [N, P] per scored row; cls_vec: [N] class (tvmonitor threshold,
    skipped classes); extra_gate: [N] the caller's liveness. Both passes
    score with the tree geometry of N_OBJ_SAMPLE, as the reference does.
    Returns the updated (pt_object_id, pt_obj_votes)."""
    P = pt_pos.shape[0]
    top_v, mem_idx = _top_k(torch.where(member, 1.0 + h[None, :], 0.0), N_IFOREST_SAMPLE)
    mem_mask = top_v > 0.0
    scores = anomaly_scores(pt_pos[mem_idx], mem_mask, draw(mem_mask), depth)   # [N, S]
    th_if = torch.where(cls_vec == IFOREST_TV_CLASS, 0.65, 0.6)[:, None]
    run_forest = extra_gate & ~_class_in(cls_vec, IFOREST_SKIP_CLASSES) & (member.sum(1) >= 30)
    outlier = mem_mask & (scores > th_if) & run_forest[:, None]
    flat_idx = torch.where(outlier, mem_idx, P).reshape(-1)
    # rows may evict the same point twice: every write is the same value
    return set_rows_drop(pt_object_id, flat_idx, -1), set_rows_drop(pt_obj_votes, flat_idx, 0)


def chunk_iforest_cull(cam: Camera, m: MapState, table: ObjectTable, T_cw, since_frame: int,
                       draw: Callable[[torch.Tensor], IForestDraws], depth: int = 7):
    """Chunk-rate isolation-forest outlier cull over every object updated
    since ``since_frame`` (the reference package's batched pacing of
    IsolationForestDeleteOutliers, src/Object.cc:1202-1309: an outlier can
    survive up to a chunk's frames before eviction), then the member stats
    refreshed on the culled membership. Draws come from ``draw(mask)``."""
    J = table.capacity
    h = subsample_hash(m.pt_pos.shape[0], 1009, m.pt_pos.device)
    member = _members(m.pt_object_id, m.pt_valid, J)
    gate = table.valid & ~table.bad & (table.last_frame >= since_frame)
    pt_object_id, pt_obj_votes = _iforest_score_and_evict(
        m.pt_pos, m.pt_object_id, m.pt_obj_votes, member, table.cls, gate, h, draw, depth)
    m = m._replace(pt_object_id=pt_object_id, pt_obj_votes=pt_obj_votes)
    center, std, cub_min, cub_max, r_max, proj_rect, has_mem = member_stats(
        cam, m.pt_pos, m.pt_valid, pt_object_id, table, T_cw, h)
    table = table._replace(center=center, std=std, cub_min=cub_min, cub_max=cub_max,
                           r_max=r_max, proj_rect=proj_rect,
                           bad=table.bad | (table.valid & ~has_mem))
    return m, table


class ObjectUpdater:
    """The interactive tracker's per-frame object pipeline (the object work
    of TrackWithMotionModel, src/Tracking.cc:1246-1647): detection
    statistics and the cascade on the device, the batched table
    update with the per-frame iForest cull, and in line mode the yaw vote.
    The iForest draws come from ``draw(mask)``: a host generator seeded
    from ``cfg.objects.iforest_seed``; tests replace it."""

    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        self.cam = cfg.camera
        self.t_table_np = stats.make_t_table()
        self.t_table = {}   # the critical values per device
        self.psi, self.depth = psi_depth_for(N_OBJ_SAMPLE)
        self.generator = torch.Generator().manual_seed(cfg.objects.iforest_seed)

    def draw(self, mask: torch.Tensor) -> IForestDraws:
        return draw_iforest(self.generator, mask, self.psi, self.depth)

    def frame_update(self, m: MapState, table: ObjectTable, frame_boxes, T_cw, kp, cur_pt,
                     frame_id: int, lines=None):
        """One frame: ``frame_boxes`` = (boxes [B, 4], class [B], score
        [B], valid [B]), T_cw [3, 4], the frame's keypoints and map point
        per feature, ``lines`` = ([L, 4], [L]) for the yaw vote. Returns
        (map_state, table, appear_new_object)."""
        bxs, cls, score, bvalid = frame_boxes
        dev = m.pt_pos.device
        T = torch.as_tensor(T_cw, dtype=torch.float32, device=dev)
        det = compute_detection_stats(self.cam, m.pt_pos, m.pt_valid, m.pt_object_id, table, T,
                                      kp, cur_pt, bxs, cls, score, bvalid, frame_id)
        res = self.resolve(det, table, bxs)
        m2, table2 = apply_frame_update(self.cam, m, table, det, res.assoc, res.new_slots, bxs,
                                        cls, T, kp, cur_pt, frame_id, draw=self.draw,
                                        depth=self.depth, run_iforest=True)
        table2 = table2._replace(re_obj=table2.re_obj + res.re_inc)
        if self.cfg.flag.use_yaw_lines and lines is not None and lines[0] is not None:
            from eao_slam_torch.objects.yaw import update_yaw, yaw_sample_scores

            targets = torch.where(res.assoc >= 0, res.assoc, res.new_slots)
            counts, errs, n_lines = yaw_sample_scores(self.cam, table2, targets, bxs, T, *lines)
            table2 = update_yaw(table2, targets, counts, errs, n_lines)
        return m2, table2, bool((res.new_slots >= 0).any())

    def resolve(self, det: FrameDetections, table: ObjectTable, bxs):
        """The cascade over the score matrices (the reference updater's host
        ``_resolve`` and ``_allocate_slots``), as the chunked tracker runs
        it: ``resolve_cascade`` on the detections' device. Returns its
        ``ResolveResult`` (assoc, new_slots, re_inc)."""
        from eao_slam_torch.objects.resolve import resolve_cascade

        dev = bxs.device
        if dev not in self.t_table:
            self.t_table[dev] = torch.as_tensor(self.t_table_np, device=dev)
        flag = self.cfg.flag
        return resolve_cascade(
            det, table, self.t_table[dev], bxs, self.cfg.objects.proj_iou_threshold,
            use_iou=flag.use_iou, use_nonparam=flag.use_nonparam, use_ttest=flag.use_ttest,
            img_w=int(self.cam.width), img_h=int(self.cam.height),
            min_points=self.cfg.objects.min_points_per_object)
