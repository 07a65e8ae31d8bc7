"""Per-frame tracking steps: motion-model, reference-keyframe and local-map
tracking, init matching and visibility counting. Matching is dense masked
matrix work over the whole point table, followed by the robust pose LM.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera, in_image, project
from eao_slam_torch.ops import matching
from eao_slam_torch.solvers.pose_lm import optimize_pose

LOG_SCALE = 0.1823215568  # log(1.2)


class TrackResult(NamedTuple):
    T: torch.Tensor          # [3, 4]
    cur_pt: torch.Tensor     # [F] int32 map-point id per feature (-1 = none)
    n_inliers: torch.Tensor  # int
    n_matches: torch.Tensor  # int (before pose optimisation)


def scatter_max(base: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``base.at[idx].max(val)``: deterministic under duplicate indices."""
    if base.dtype == torch.bool:
        return scatter_max(base.to(torch.uint8), idx, val.to(torch.uint8)).bool()
    return base.scatter_reduce(0, idx.long(), val.to(base.dtype), "amax")


def set_rows_drop(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``arr.at[idx].set(val, mode="drop")`` for indices that are unique
    within range; an index equal to len(arr) is dropped. Returns a new
    tensor (no host sync: dropped rows land in a scratch row)."""
    ext = torch.cat([arr, arr[:1]], 0)
    ext[idx.long()] = val.to(arr.dtype) if torch.is_tensor(val) else val
    return ext[: arr.shape[0]]


def set_last_wins(arr: torch.Tensor, sorted_idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``arr.at[sorted_idx].set(val)`` for SORTED indices with duplicates,
    where the last update of each index wins, as XLA's CPU scatter applies
    them. Deterministic on every device."""
    last = torch.cat([sorted_idx[1:] != sorted_idx[:-1],
                      torch.ones(1, dtype=torch.bool, device=sorted_idx.device)])
    # scatter only the last occurrence of each index (all others go to a
    # scratch row), so the written indices are unique
    idx = torch.where(last, sorted_idx, arr.shape[0])
    return set_rows_drop(arr, idx, val)


def _octave_clip(octave, n):
    return torch.clamp(octave, 0, n - 1).long()


def track_motion_model(cam: Camera, pt_pos, pt_valid, T_pred,
                       last_kp, last_desc, last_octave, last_angle, last_valid, last_pt,
                       kp, desc, octave, angle, valid, scale2,
                       radius: float = 15.0) -> TrackResult:
    """Project the last frame's map points with the constant-velocity
    prediction, window-match into this frame, run the robust pose LM."""
    P = pt_pos.shape[0]
    F = kp.shape[0]
    q_pt = torch.clamp(last_pt, 0, P - 1).long()
    Xw = pt_pos[q_pt]
    q_valid = last_valid & (last_pt >= 0) & pt_valid[q_pt]
    xc = se3.apply(T_pred, Xw)
    proj = project(cam, xc)
    q_valid = q_valid & (xc[..., 2] > 0.05) & in_image(cam, proj)
    rad = radius * torch.sqrt(scale2)[_octave_clip(last_octave, scale2.shape[0])]
    idx, d, ok = matching.search_by_projection(
        proj, last_octave, last_desc, q_valid, kp, octave, desc, valid, rad,
        query_angle=last_angle, kp_angle=angle,
        max_dist=matching.TH_HIGH, ratio=0.9, check_rotation=True,
    )
    il = idx.long()
    uv_m = kp[il]
    inv_s2 = 1.0 / scale2[_octave_clip(octave[il], scale2.shape[0])]
    res = optimize_pose(cam, T_pred, Xw, uv_m, inv_s2, ok)
    keep = ok & res.inliers
    cur_pt = scatter_max(torch.full((F,), -1, dtype=torch.int32, device=kp.device),
                         il, torch.where(keep, last_pt, -1))
    return TrackResult(res.T, cur_pt, keep.sum(), ok.sum())


def track_reference_kf(cam: Camera, pt_pos, pt_valid, T0, ref_desc, ref_valid, ref_pt,
                       kp, desc, octave, valid, scale2) -> TrackResult:
    """Brute descriptor match against the reference keyframe's mapped
    features + pose LM from the last pose (TrackReferenceKeyFrame)."""
    P = pt_pos.shape[0]
    F = kp.shape[0]
    q_pt = torch.clamp(ref_pt, 0, P - 1).long()
    q_valid = ref_valid & (ref_pt >= 0) & pt_valid[q_pt]
    idx, d, ok = matching.search_brute(ref_desc, q_valid, desc, valid,
                                       max_dist=matching.TH_LOW, ratio=0.7)
    il = idx.long()
    Xw = pt_pos[q_pt]
    uv_m = kp[il]
    inv_s2 = 1.0 / scale2[_octave_clip(octave[il], scale2.shape[0])]
    res = optimize_pose(cam, T0, Xw, uv_m, inv_s2, ok)
    keep = ok & res.inliers
    cur_pt = scatter_max(torch.full((F,), -1, dtype=torch.int32, device=kp.device),
                         il, torch.where(keep, ref_pt, -1))
    return TrackResult(res.T, cur_pt, keep.sum(), ok.sum())


def _visibility(cam: Camera, pt_pos, T):
    """Camera-frame points, projections, viewing rays and distances."""
    xc = se3.apply(T, pt_pos)
    proj = project(cam, xc)
    Ow = se3.trans(se3.inverse(T))
    view = pt_pos - Ow[None, :]
    dist = torch.linalg.norm(view, dim=-1)
    return xc, proj, view, dist


def track_local_map_step(cam: Camera, pt_pos, pt_valid, pt_desc, pt_normal,
                         pt_min_dist, pt_max_dist, T, cur_pt,
                         kp, desc, octave, valid, scale2, n_levels: int = 8) -> TrackResult:
    """Project the whole map through the current estimate, match the still
    unmatched features, rerun the pose LM over the union of matches."""
    P = pt_pos.shape[0]
    F = kp.shape[0]
    matched_pt = scatter_max(torch.zeros(P, dtype=torch.bool, device=kp.device),
                             torch.clamp(cur_pt, 0, P - 1), cur_pt >= 0)
    xc, proj, view, dist = _visibility(cam, pt_pos, T)
    dist_safe = torch.clamp(dist, min=1e-9)
    visible = pt_valid & (xc[..., 2] > 0.05) & in_image(cam, proj)
    visible = visible & (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
    cos_view = (view * pt_normal).sum(-1) / dist_safe
    visible = visible & (cos_view > 0.5)
    lvl = torch.ceil(torch.log(torch.clamp(pt_max_dist, min=1e-9) / dist_safe) / LOG_SCALE)
    lvl = torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)
    rad_base = torch.where(cos_view > 0.998, 2.5, 4.0)
    rad = rad_base * torch.sqrt(scale2)[lvl.long()]
    q_valid = visible & ~matched_pt
    train_valid = valid & (cur_pt < 0)
    idx, d, ok = matching.search_by_projection(
        proj, lvl, pt_desc, q_valid, kp, octave, desc, train_valid, rad,
        max_dist=matching.TH_HIGH, ratio=0.8,
    )
    pt_ids = torch.arange(P, dtype=torch.int32, device=kp.device)
    cur_pt2 = scatter_max(cur_pt, idx, torch.where(ok, pt_ids, -1))
    m_valid = (cur_pt2 >= 0) & valid
    Xw_f = pt_pos[torch.clamp(cur_pt2, 0, P - 1).long()]
    inv_s2 = 1.0 / scale2[_octave_clip(octave, scale2.shape[0])]
    res = optimize_pose(cam, T, Xw_f, kp, inv_s2, m_valid)
    cur_pt3 = torch.where(m_valid & res.inliers, cur_pt2, -1)
    return TrackResult(res.T, cur_pt3, (cur_pt3 >= 0).sum(), m_valid.sum())


def match_for_init(kp1, desc1, angle1, valid1, kp2, desc2, angle2, valid2):
    """SearchForInitialization (100 px window, 0.9 ratio)."""
    return matching.search_for_initialization(
        kp1, desc1, angle1, valid1, kp2, desc2, angle2, valid2,
        window=100.0, max_dist=matching.TH_LOW, ratio=0.9,
    )


def count_visible(pt_pos, pt_valid, T, cam_fx, cam_fy, cam_cx, cam_cy, w, h):
    """Valid map points that project into the frame at pose T."""
    xc = se3.apply(T, pt_pos)
    z = torch.clamp(xc[..., 2], min=1e-9)
    u = cam_fx * xc[..., 0] / z + cam_cx
    v = cam_fy * xc[..., 1] / z + cam_cy
    ok = pt_valid & (xc[..., 2] > 0.05) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return ok.sum()
