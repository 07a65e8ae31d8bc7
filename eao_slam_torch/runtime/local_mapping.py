"""Local mapping: new-point triangulation, fusion and windowed BA assembly."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera, project
from eao_slam_torch.geometry.triangulate import (
    check_triangulation,
    pixels_to_normalized,
    triangulate,
)
from eao_slam_torch.ops import matching
from eao_slam_torch.runtime.map_state import MapState
from eao_slam_torch.runtime.tracking_kernels import LOG_SCALE, scatter_max
from eao_slam_torch.solvers.ba import BAProblem, BAResult, local_ba


class TriangulationResult(NamedTuple):
    idx2: torch.Tensor    # [F] match in the neighbour per new-KF feature
    points: torch.Tensor  # [F, 3]
    good: torch.Tensor    # [F] bool


def _octave_clip(octave, n):
    return torch.clamp(octave, 0, n - 1).long()


def triangulate_with_neighbor(cam: Camera, T1, kp1, desc1, oct1, valid1, pt1,
                              T2, kp2, desc2, oct2, valid2, pt2,
                              scale2) -> TriangulationResult:
    """Epipolar-constrained matching of both keyframes' unmatched features
    + batched DLT triangulation with the CheckRT-style gates
    (LocalMapping::CreateNewMapPoints)."""
    F12 = matching.fundamental_from_poses(cam.K(T1.device), T1, T2)
    O1 = se3.trans(se3.inverse(T1))
    epi2 = project(cam, se3.apply(T2, O1))
    min_epi2 = 100.0 * scale2[_octave_clip(oct2, scale2.shape[0])]
    un1 = valid1 & (pt1 < 0)
    un2 = valid2 & (pt2 < 0)
    idx, d, ok = matching.search_for_triangulation(
        kp1, desc1, oct1, un1, kp2, desc2, oct2, un2,
        F12, scale2, epi2, min_epi2, max_dist=matching.TH_LOW,
    )
    il = idx.long()
    xn1 = pixels_to_normalized(cam, kp1)
    xn2 = pixels_to_normalized(cam, kp2)[il]
    Xw = triangulate(T1[None], T2[None], xn1, xn2)
    s2 = scale2[_octave_clip(oct1, scale2.shape[0])]
    good = ok & check_triangulation(cam, T1, T2, Xw, kp1, kp2[il], s2)
    return TriangulationResult(idx2=idx, points=Xw, good=good)


def fuse_into_keyframe(cam: Camera, pt_pos, pt_valid, pt_desc, pt_min_dist, pt_max_dist,
                       T, kp, desc, octave, valid, cur_pt, scale2):
    """Project map points into a keyframe and bind unmatched features that
    lie on them (the duplicate-descriptor half of ORBmatcher::Fuse).
    Returns the updated feature -> point row [F]."""
    P = pt_pos.shape[0]
    matched_pt = scatter_max(torch.zeros(P, dtype=torch.bool, device=pt_pos.device),
                             torch.clamp(cur_pt, 0, P - 1), cur_pt >= 0)
    xc = se3.apply(T, pt_pos)
    proj = project(cam, xc)
    Ow = se3.trans(se3.inverse(T))
    dist = torch.linalg.norm(pt_pos - Ow[None, :], dim=-1)
    visible = pt_valid & ~matched_pt & (xc[..., 2] > 0.05)
    visible = visible & (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
    lvl = torch.clamp(
        torch.ceil(torch.log(torch.clamp(pt_max_dist, min=1e-9)
                             / torch.clamp(dist, min=1e-9)) / LOG_SCALE),
        0, scale2.shape[0] - 1,
    ).to(torch.int32)
    rad = 3.0 * torch.sqrt(scale2)[lvl.long()]
    idx, d, ok = matching.search_by_projection(
        proj, lvl, pt_desc, visible, kp, octave, desc, valid & (cur_pt < 0), rad,
        max_dist=matching.TH_LOW, ratio=1.0,
    )
    pt_ids = torch.arange(P, dtype=torch.int32, device=pt_pos.device)
    return scatter_max(cur_pt, idx, torch.where(ok, pt_ids, -1))


class LocalBAResult(NamedTuple):
    kf_slots: np.ndarray   # [W] map keyframe slots in the window
    poses: torch.Tensor    # [W, 3, 4]
    pt_slots: np.ndarray   # [Pl] map point slots (-1 pad)
    points: torch.Tensor   # [Pl, 3]
    drop_obs: np.ndarray   # [W, F] bool observations classified outliers


def run_local_ba(cam: Camera, state: MapState, window_slots: Sequence[int],
                 fixed_slots: Sequence[int], scale2: np.ndarray,
                 max_points: int) -> LocalBAResult:
    """Host-assembled compact BAProblem over a keyframe window, solved with
    the 5 + 10 LM schedule (used by the two-keyframe bootstrap)."""
    dev = state.kf_pose.device
    W = len(window_slots)
    ws = np.asarray(window_slots, np.int64)
    wst = torch.as_tensor(ws, device=dev)
    kf_pt = state.kf_pt_idx[wst].cpu().numpy()
    kf_oct = state.kf_octave[wst].cpu().numpy()
    kf_kp_valid = state.kf_kp_valid[wst].cpu().numpy()
    F = kf_pt.shape[1]
    P = state.pt_pos.shape[0]

    obs_mask = (kf_pt >= 0) & kf_kp_valid
    pt_slots = np.unique(kf_pt[obs_mask])
    if len(pt_slots) > max_points:
        counts = np.zeros(P, np.int64)
        np.add.at(counts, kf_pt[obs_mask], 1)
        order = np.argsort(-counts[pt_slots], kind="stable")
        pt_slots = np.sort(pt_slots[order[:max_points]])
    Pl = max_points
    remap = np.full(P + 1, -1, np.int64)
    remap[pt_slots] = np.arange(len(pt_slots))
    local_pt = remap[np.clip(kf_pt, 0, len(remap) - 1)]
    obs_mask = obs_mask & (local_pt >= 0)
    kf_idx = np.broadcast_to(np.arange(W)[:, None], (W, F))
    inv_s2 = 1.0 / scale2[np.clip(kf_oct, 0, len(scale2) - 1)]

    points = torch.zeros((Pl, 3), dtype=torch.float32, device=dev)
    pt_valid = torch.zeros(Pl, dtype=torch.bool, device=dev)
    if len(pt_slots):
        points[: len(pt_slots)] = state.pt_pos[torch.as_tensor(pt_slots, device=dev)]
        pt_valid[: len(pt_slots)] = True
    fixed = np.isin(ws, np.asarray(fixed_slots))
    if not fixed.any():
        fixed[0] = True

    def t(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)

    prob = BAProblem(
        poses=state.kf_pose[wst],
        points=points,
        kf_idx=t(kf_idx.reshape(-1), torch.int64),
        pt_idx=t(np.clip(local_pt, 0, Pl - 1).reshape(-1), torch.int64),
        uv=state.kf_kp[wst].reshape(-1, 2),
        inv_sigma2=t(inv_s2.reshape(-1).astype(np.float32), torch.float32),
        obs_valid=t(obs_mask.reshape(-1), torch.bool),
        cam_fixed=t(fixed, torch.bool),
        cam_valid=torch.ones(W, dtype=torch.bool, device=dev),
        pt_valid=pt_valid,
    )
    res: BAResult = local_ba(cam, prob)
    inlier = res.obs_inlier.reshape(W, F).cpu().numpy()
    pt_slots_padded = np.full(Pl, -1, np.int64)
    pt_slots_padded[: len(pt_slots)] = pt_slots
    return LocalBAResult(kf_slots=ws, poses=res.poses, pt_slots=pt_slots_padded,
                         points=res.points, drop_obs=obs_mask & ~inlier)
