"""Map maintenance for the chunked path: keyframe culling, slot compaction
and the covisibility product.

The chunk program allocates keyframe and point slots monotonically (slot ==
insertion order), which the windowed BA relies on. Long sequences would
exhaust capacity, so between chunks the tracker runs this pass: cull
redundant keyframes (LocalMapping::KeyFrameCulling), drop under-observed
points, then stably compact both tables to the front. Surviving keyframes
keep their insertion order, so the monotonic invariant holds again with
freed tail capacity. Same rules and tie-breaks as the reference package's
``runtime/compaction.py``; every count is an integer, so the remaps are
bit-exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eao_slam_torch.device import fp32_solvers
from eao_slam_torch.runtime.map_state import MapState


def covisibility(kf_pt_idx: torch.Tensor, kf_kp_valid: torch.Tensor,
                 kf_valid: torch.Tensor, n_points: int) -> torch.Tensor:
    """[K, K] int32 count of the map points two keyframes share (zero
    diagonal): one product of the 0/1 keyframe x point incidence with
    itself. Entries are 0 or 1 and the sums stay far below 2^24, so the
    float32 product is exact."""
    fp32_solvers()
    K = kf_pt_idx.shape[0]
    obs_ok = (kf_pt_idx >= 0) & kf_kp_valid & kf_valid[:, None]
    dest = torch.where(obs_ok, kf_pt_idx, n_points).long()
    inc = torch.zeros((K, n_points + 1), dtype=torch.float32, device=kf_pt_idx.device)
    inc.scatter_(1, dest, 1.0)
    inc = inc[:, :n_points]
    C = (inc @ inc.T).to(torch.int32)
    return C * (1 - torch.eye(K, dtype=torch.int32, device=C.device))


class MaintResult(NamedTuple):
    m: MapState
    kf_count: int            # compacted keyframe count
    pt_count: int            # compacted point count
    pt_remap: torch.Tensor   # [P] old point id -> new id (-1 = dropped)
    kf_remap: torch.Tensor   # [K] old keyframe slot -> new slot (-1 = culled)
    n_culled_kf: int


def _count(n_rows: int, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Integer histogram: the order of the additions cannot matter."""
    out = torch.zeros(n_rows, dtype=torch.int32, device=idx.device)
    return out.index_add_(0, idx.reshape(-1).long(), weight.reshape(-1).to(torch.int32))


def cull_and_compact(m: MapState, kf_count: int, pt_count: int, n_levels: int = 8,
                     max_cull: int = 4, redundancy: float = 0.9) -> MaintResult:
    """KeyFrameCulling + point culling + stable slot compaction.

    A keyframe >= 90 % of whose tracked points are observed by >= 3 other
    keyframes at the same or a finer octave is redundant. Object-created
    keyframes, the first two and the newest two are exempt; at most
    ``max_cull`` die per pass, the highest ratios first (ties: lower slot).
    Points then observed by < 2 keyframes die, and both tables compact
    stably to the front. ``pt_count`` is unused, as in the reference (the
    compacted count is the number of valid points)."""
    K, F = m.kf_pt_idx.shape
    P = m.pt_pos.shape[0]
    L = n_levels
    dev = m.pt_pos.device

    # per-(point, octave) observation counts, cumulative over octave
    obs_ok = (m.kf_pt_idx >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    p_of = torch.where(obs_ok, m.kf_pt_idx, P).long()
    oct_of = torch.clamp(m.kf_octave, 0, L - 1).long()
    cnt = _count((P + 1) * L, p_of * L + oct_of, obs_ok).reshape(P + 1, L)
    cnt_le = torch.cumsum(cnt, 1)

    # redundancy per keyframe
    o_plus = torch.clamp(oct_of + 1, 0, L - 1)
    others = cnt_le[p_of, o_plus] - 1                     # exclude self
    red_f = obs_ok & (others >= 3)
    n_tracked = obs_ok.sum(1, dtype=torch.int32)
    n_red = red_f.sum(1, dtype=torch.int32)

    slot_order = torch.arange(K, device=dev)
    protected = (~m.kf_valid | m.kf_by_object | (slot_order < 2)
                 | (slot_order >= kf_count - 2))
    ratio = n_red.to(torch.float32) / torch.clamp(n_tracked, min=1).to(torch.float32)
    redundant = ~protected & (n_tracked > 0) & (ratio >= redundancy)
    # cap the batch: top max_cull by ratio, the lower slot first on ties
    # (as lax.top_k); a stable sort keeps that order on every device
    score = torch.where(redundant, ratio, -1.0)
    top_i = torch.sort(score, descending=True, stable=True).indices[:max_cull]
    cull = torch.zeros(K, dtype=torch.bool, device=dev)
    cull[top_i] = score[top_i] > 0

    kf_valid = m.kf_valid & ~cull
    kf_pt_idx = torch.where(cull[:, None], -1, m.kf_pt_idx)

    # point culling: < 2 observations from surviving keyframes
    obs_ok2 = (kf_pt_idx >= 0) & m.kf_kp_valid & kf_valid[:, None]
    pcnt = _count(P + 1, torch.where(obs_ok2, kf_pt_idx, P), obs_ok2)[:P]
    pt_valid = m.pt_valid & (pcnt >= 2)

    # stable compaction: valid entries to the front, order preserved
    pt_remap = torch.where(pt_valid, torch.cumsum(pt_valid, 0, dtype=torch.int32) - 1, -1)
    p_order = torch.sort((~pt_valid).to(torch.uint8), stable=True).indices
    kf_remap = torch.where(kf_valid, torch.cumsum(kf_valid, 0, dtype=torch.int32) - 1, -1)
    k_order = torch.sort((~kf_valid).to(torch.uint8), stable=True).indices

    new_kf_pt = torch.where(kf_pt_idx >= 0,
                            pt_remap[torch.clamp(kf_pt_idx, 0, P - 1).long()], -1)
    new_first_kf = torch.where(m.pt_first_kf >= 0,
                               kf_remap[torch.clamp(m.pt_first_kf, 0, K - 1).long()], -1)
    kf_fields = dict(kf_valid=kf_valid, kf_pt_idx=new_kf_pt)
    pt_fields = dict(pt_valid=pt_valid, pt_first_kf=new_first_kf)
    new = {}
    for f in MapState._fields:
        if f.startswith("kf_"):
            new[f] = kf_fields.get(f, getattr(m, f))[k_order]
        else:
            new[f] = pt_fields.get(f, getattr(m, f))[p_order]
    # one readback for the three counts
    n_kf, n_pt, n_culled = torch.stack([kf_valid.sum(), pt_valid.sum(), cull.sum()]).tolist()
    return MaintResult(m=MapState(**new), kf_count=n_kf, pt_count=n_pt,
                       pt_remap=pt_remap, kf_remap=kf_remap,
                       n_culled_kf=n_culled)
