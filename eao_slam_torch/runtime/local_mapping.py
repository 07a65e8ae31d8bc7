"""Local mapping: new-point triangulation, fusion both ways, the duplicate
merge, the descriptor refresh and windowed BA assembly (the LocalMapping
thread's per-keyframe work, src/LocalMapping.cc:42-117)."""

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
from eao_slam_torch.runtime.tracking_kernels import LOG_SCALE, scatter_max, set_last_wins
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


def _scatter_last_wins(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].set(val, mode="drop")`` with duplicate indices, the
    last write in index order winning as the reference's CPU scatter
    applies it; an index equal to len(arr) is dropped."""
    order = torch.sort(idx, stable=True)
    return set_last_wins(arr, order.values, val[order.indices])


def refresh_point_descriptors(kf_pt_idx, kf_desc, kf_kp_valid, pt_desc, win, win_valid):
    """MapPoint::ComputeDistinctiveDescriptors over a keyframe window
    ``win`` [W] (``win_valid`` [W]): each point observed at least twice in
    the window may take the observation descriptor whose median hamming
    distance to its other window observations is smallest, and does so
    only when that median beats the current descriptor's by 8 bits or more
    (the reference's sticky update). Ties go to the first window keyframe.
    Returns the new pt_desc [P, 8]."""
    P = pt_desc.shape[0]
    W = win.shape[0]
    dev = pt_desc.device
    BIG = 10_000
    cand = torch.zeros((P, W, 8), dtype=torch.int32, device=dev)
    cand_ok = torch.zeros((P, W), dtype=torch.bool, device=dev)
    for w in range(W):
        row = kf_pt_idx[win[w]]
        ok = (row >= 0) & kf_kp_valid[win[w]] & win_valid[w]
        dest = torch.where(ok, row, P).long()
        cand[:, w] = _scatter_last_wins(cand[:, w], dest, kf_desc[win[w]])
        cand_ok[:, w] = _scatter_last_wins(cand_ok[:, w], dest, ok)

    c64 = cand.view(torch.int64)                                     # [P, W, 4]
    ham = matching.popcount64(c64[:, :, None, :] ^ c64[:, None, :, :]).sum(-1)
    pair_ok = cand_ok[:, :, None] & cand_ok[:, None, :]
    ham = torch.where(pair_ok, ham, BIG)
    srt = torch.sort(ham, dim=-1).values                             # [P, W, W]
    n_valid = cand_ok.sum(1)
    med_idx = torch.clamp((n_valid - 1) // 2, 0, W - 1)             # [P]
    med = torch.gather(srt, 2, med_idx[:, None, None].expand(P, W, 1))[..., 0]
    med = torch.where(cand_ok, med, BIG)
    key = med * W + torch.arange(W, device=dev)[None, :]
    best = key.amin(1)
    best_w, best_med = best % W, best // W
    new_desc = cand[torch.arange(P, device=dev), best_w]

    cur_d = matching.popcount64(pt_desc.view(torch.int64)[:, None, :] ^ c64).sum(-1)
    cur_d = torch.where(cand_ok, cur_d, BIG)
    cur_med = torch.gather(torch.sort(cur_d, dim=-1).values, 1, med_idx[:, None])[:, 0]
    refresh = (n_valid >= 2) & (best_med + 8 <= cur_med)
    return torch.where(refresh[:, None], new_desc, pt_desc)


def merge_duplicate_points(cam: Camera, pt_pos, pt_valid, pt_desc, pt_min_dist, pt_max_dist,
                           kf_pt_idx, T, kp, desc, octave, valid, cur_pt, scale2):
    """The Replace half of ORBmatcher::Fuse (MapPoint::Replace): map points
    projected into a keyframe that match a feature already holding a
    different point, within 2 % of the depth in 3D, merge with it; the
    point with fewer observations is replaced by the other in the whole
    observation table ``kf_pt_idx`` [K, F] and dies. Merge chains are
    squashed twice. Returns (kf_pt_idx, pt_valid)."""
    P = pt_pos.shape[0]
    dev = pt_pos.device
    matched_pt = scatter_max(torch.zeros(P, dtype=torch.bool, device=dev),
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
        proj, lvl, pt_desc, visible, kp, octave, desc, valid & (cur_pt >= 0), rad,
        max_dist=matching.TH_LOW, ratio=1.0,
    )
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    other = cur_pt[idx.long()]
    dup = ok & (other >= 0) & (other != ids)
    o = torch.clamp(other, 0, P - 1).long()
    sep = torch.linalg.norm(pt_pos - pt_pos[o], dim=-1)
    dup = dup & (sep < 0.02 * torch.clamp(dist, min=1e-6))

    n_obs = torch.zeros(P, dtype=torch.int32, device=dev).index_add_(
        0, torch.clamp(kf_pt_idx, 0, P - 1).reshape(-1).long(),
        (kf_pt_idx >= 0).reshape(-1).to(torch.int32))
    self_wins = n_obs >= n_obs[o]
    winner = torch.where(self_wins, ids, o.to(torch.int32))
    loser = torch.where(self_wins, o.to(torch.int32), ids)
    rmap = _scatter_last_wins(ids.clone(), torch.where(dup, loser, P).long(),
                              torch.where(dup, winner, 0))
    rmap = rmap[rmap.long()]
    rmap = rmap[rmap.long()]
    new_kf_pt = torch.where(kf_pt_idx >= 0, rmap[torch.clamp(kf_pt_idx, 0, P - 1).long()],
                            kf_pt_idx)
    return new_kf_pt, pt_valid & (rmap == ids)


class LocalBAResult(NamedTuple):
    kf_slots: np.ndarray   # [W] map keyframe slots in the window
    poses: torch.Tensor    # [W, 3, 4]
    pt_slots: np.ndarray   # [Pl] map point slots (-1 pad)
    points: torch.Tensor   # [Pl, 3]
    drop_obs: np.ndarray   # [W, F] bool observations classified outliers


def run_local_ba(cam: Camera, state: MapState, window_slots: Sequence[int],
                 fixed_slots: Sequence[int], scale2: np.ndarray,
                 max_points: int, solver=None) -> LocalBAResult:
    """Host-assembled compact BAProblem over a keyframe window, solved with
    the 5 + 10 LM schedule (used by the two-keyframe bootstrap and the
    global BA): ``solvers.ba.local_ba`` by default, or ``solver(cam, prob)
    -> BAResult`` when given (a mesh-parallel tracker passes the
    distributed solver here)."""
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
    res: BAResult = (solver or local_ba)(cam, prob)
    inlier = res.obs_inlier.reshape(W, F).cpu().numpy()
    pt_slots_padded = np.full(Pl, -1, np.int64)
    pt_slots_padded[: len(pt_slots)] = pt_slots
    return LocalBAResult(kf_slots=ws, poses=res.poses, pt_slots=pt_slots_padded,
                         points=res.points, drop_obs=obs_mask & ~inlier)
