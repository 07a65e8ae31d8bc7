"""Map-level object merge and overlap resolution, between chunks.

The LocalMapping-side object work (src/LocalMapping.cc:772-882) as the
reference package formulates it:
- MergePotentialAssObjs (src/Object.cc:1607-1654): objects flagged as
  potential associations at least 3 times merge into the better-observed
  one, gated on never having been seen in the same frame;
- DealTwoOverlapObjs (src/Object.cc:2077-2178): five cases of
  3D-overlapping cuboids: merge, false-positive deletion by volume,
  equal division, big-to-small point eviction.

The pair statistics are one packed tensor and one readback
(``merge_stats_packed``); the rare decisions run on the host
(``run_merge_pass``); the membership rewrites and the stats refresh run on
the device (``apply_object_edits``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from eao_slam_torch.objects.state import ObjectTable, yaw_rotation
from eao_slam_torch.runtime.map_state import MapState


def member_stats(m: MapState, table: ObjectTable):
    """Centre, std, object-frame AABB and r_max from point membership over
    the whole table (ComputeMeanAndStandard, src/Object.cc:967-1198); an
    object without members gets a zero centre here."""
    J = table.capacity
    member = (m.pt_object_id[None, :] == torch.arange(J, device=m.pt_pos.device)[:, None]) \
        & m.pt_valid[None, :]
    mw = member.to(torch.float32)
    n_mem = mw.sum(1)
    denom = torch.clamp(n_mem, min=1.0)[:, None]
    center = (mw @ m.pt_pos) / denom
    std = torch.sqrt(torch.clamp((mw @ m.pt_pos ** 2) / denom - center ** 2, min=1e-12))
    x_obj = torch.einsum("jba,jpb->jpa", yaw_rotation(table.yaw),
                         m.pt_pos[None, :, :] - center[:, None, :])
    big = 1e9
    has = (n_mem > 0)[:, None]
    zero = torch.zeros_like(center)
    cub_min = torch.where(has, torch.where(member[..., None], x_obj, big).amin(1), zero)
    cub_max = torch.where(has, torch.where(member[..., None], x_obj, -big).amax(1), zero)
    r_max = torch.linalg.norm(torch.maximum(cub_min.abs(), cub_max.abs()), dim=-1)
    return member, n_mem, center, std, cub_min, cub_max, r_max


def merge_stats_packed(m: MapState, table: ObjectTable) -> torch.Tensor:
    """Everything the host decisions read, as one flat float32 tensor, so
    the pass costs one device-to-host copy: pairwise cuboid overlap flags,
    per-axis overlaps and 3D IoU, co-occurrence and potential-association
    votes, volumes, member counts, validity, observation counts, classes,
    centres and the world-frame AABBs."""
    J = table.capacity
    size = table.cub_max - table.cub_min
    cub_center = table.center + 0.5 * (table.cub_min + table.cub_max)
    dis = (cub_center[:, None, :] - cub_center[None, :, :]).abs()
    sum_half = 0.5 * (size[:, None, :] + size[None, :, :])
    overlap = sum_half - dis                                       # [J, J, 3]
    overlaps = (dis < sum_half).all(-1)
    vol = torch.clamp(size, min=0.0).prod(-1)
    ov_vol = torch.clamp(overlap, min=0.0).prod(-1)
    iou3d = ov_vol / torch.clamp(vol[:, None] + vol[None, :] - ov_vol, min=1e-9)
    member_count = ((m.pt_object_id[None, :] == torch.arange(J, device=vol.device)[:, None])
                    & m.pt_valid[None, :]).sum(1)
    valid = table.valid & ~table.bad
    f32 = torch.float32
    return torch.cat([
        overlaps.to(f32).reshape(-1), overlap.reshape(-1), iou3d.reshape(-1),
        table.co_occur.to(f32).reshape(-1), table.re_obj.to(f32).reshape(-1),
        vol, member_count.to(f32), valid.to(f32), table.n_obs.to(f32), table.cls.to(f32),
        table.center.reshape(-1), (table.center + table.cub_min).reshape(-1),
        (table.center + table.cub_max).reshape(-1),
    ])


def _unpack_merge_stats(flat: np.ndarray, J: int):
    """Host-side unpack of ``merge_stats_packed``'s layout."""
    o = [0]

    def take(*shape):
        n = int(np.prod(shape))
        out = flat[o[0]:o[0] + n].reshape(shape)
        o[0] += n
        return out

    ov_np = take(J, J) > 0.5
    ovl = take(J, J, 3)
    iou_np = take(J, J)
    co = take(J, J)
    re = take(J, J)
    vol_np = take(J)
    nmem = take(J)
    valid = take(J) > 0.5
    n_obs = take(J).astype(np.int64)
    cls = take(J).astype(np.int64)
    center = take(J, 3)
    cmin = take(J, 3)
    cmax = take(J, 3)
    return ov_np, ovl, iou_np, co, re, vol_np, nmem, valid, n_obs, cls, center, cmin, cmax


def apply_object_edits(m: MapState, table: ObjectTable, merges, evicts, kill: np.ndarray):
    """Membership rewrites for the host's decisions, then a full stats
    refresh. merges: [(winner, loser)], in decision order; evicts: [(object,
    lo [3], hi [3])], world-frame regions whose members leave the object;
    kill: [J] bool host array of objects to bad-erase."""
    J = table.capacity
    dev = m.pt_pos.device
    owner, votes = m.pt_object_id, m.pt_obj_votes

    # a loser's members move to the winner when inside 1.1 x the winner's
    # cuboid (MergeTwoMapObjs' scale gate, src/Object.cc:1722-1729), else
    # leave; the table stays as it was until all merges are applied
    for w, l in merges:
        x_obj = (m.pt_pos - table.center[w]) @ yaw_rotation(table.yaw[w])  # R^T applied
        half = 0.5 * (table.cub_max[w] - table.cub_min[w])
        inside = (x_obj.abs() <= 1.1 * torch.clamp(half, min=1e-6)).all(-1)
        from_loser = owner == l
        owner = torch.where(from_loser, torch.where(inside, w, -1), owner).to(torch.int32)
        votes = torch.where(from_loser, inside.to(torch.int32), votes)

    # regional evictions (DivideEquallyTwoObjs / BigToSmall)
    for o, lo, hi in evicts:
        lo_t = torch.as_tensor(np.asarray(lo, np.float32), device=dev)
        hi_t = torch.as_tensor(np.asarray(hi, np.float32), device=dev)
        inside = ((m.pt_pos > lo_t[None]) & (m.pt_pos < hi_t[None])).all(-1)
        hit = (owner == o) & inside
        owner = torch.where(hit, -1, owner)
        votes = torch.where(hit, 0, votes)

    # killed objects lose their members
    kill_t = torch.as_tensor(kill, device=dev)
    killed_pt = (owner >= 0) & kill_t[torch.clamp(owner, 0, J - 1).long()]
    owner = torch.where(killed_pt, -1, owner)
    votes = torch.where(killed_pt, 0, votes)
    m = m._replace(pt_object_id=owner, pt_obj_votes=votes)

    # the winner inherits the loser's observation count and centroid sums
    n_obs, cent_sum, cent_sumsq = table.n_obs.clone(), table.cent_sum.clone(), \
        table.cent_sumsq.clone()
    losers = np.zeros(J, bool)
    for w, l in merges:
        n_obs[w] += n_obs[l]
        cent_sum[w] += cent_sum[l]
        cent_sumsq[w] += cent_sumsq[l]
        losers[l] = True
    table = table._replace(n_obs=n_obs, cent_sum=cent_sum, cent_sumsq=cent_sumsq)
    bad = table.bad | torch.as_tensor(kill | losers, device=dev)
    valid = table.valid & ~bad

    _, n_mem, center, std, cub_min, cub_max, r_max = member_stats(m, table)
    center = torch.where((n_mem > 0)[:, None], center, table.center)
    bad = bad | (valid & (n_mem == 0))       # an emptied object dies (src/Object.cc:1046)
    valid = valid & ~bad
    n_f = torch.clamp(table.n_obs, min=1).to(torch.float32)[:, None]
    mean_c = table.cent_sum / n_f
    center_std = torch.sqrt(torch.clamp(table.cent_sumsq / n_f - mean_c ** 2, min=1e-12))
    return m, table._replace(bad=bad, valid=valid, center=center, std=std,
                             center_std=center_std, cub_min=cub_min, cub_max=cub_max,
                             r_max=r_max)


def run_merge_pass(m: MapState, table: ObjectTable):
    """The whole pass; returns (map_state, table, merges, kills): the
    inputs themselves when nothing changes, and the number of merged pairs
    and of objects deleted as false positives. Every decision input
    arrives in one readback."""
    J = table.capacity
    (ov_np, ovl, iou_np, co, re, vol_np, nmem, valid, n_obs, cls,
     center, cmin, cmax) = _unpack_merge_stats(merge_stats_packed(m, table).cpu().numpy(), J)
    merges: List[Tuple[int, int]] = []
    evicts: List[Tuple[int, np.ndarray, np.ndarray]] = []
    kill = np.zeros((J,), bool)
    gone = np.zeros((J,), bool)

    def do_merge(i, j):
        # the better-observed object wins (WhetherMergeTwoMapObjs)
        w, l = (i, j) if n_obs[i] >= n_obs[j] else (j, i)
        merges.append((w, l))
        gone[l] = True

    # potential-association merges
    for i in range(J):
        if not valid[i] or gone[i] or n_obs[i] < 10:
            continue
        for j in range(J):
            if i == j or not valid[j] or gone[j] or gone[i]:
                continue
            if re[i, j] >= 3 and co[i, j] == 0:
                do_merge(i, j)

    # overlap handling (DealTwoOverlapObjs' cases)
    for i in range(J):
        if not valid[i] or gone[i] or nmem[i] < 10 or n_obs[i] < 10:
            continue
        for j in range(i + 1, J):
            if not valid[j] or gone[j] or gone[i] or nmem[j] < 10 or n_obs[j] < 10:
                continue
            if not ov_np[i, j]:
                continue
            b_iou = iou_np[i, j] >= 0.3
            b_volume = (vol_np[i] > 2 * vol_np[j]) or (vol_np[j] > 2 * vol_np[i])
            b_same_time = co[i, j] > 3
            b_class = cls[i] == cls[j]

            if b_iou and not b_volume and not b_same_time and b_class:     # case 1
                do_merge(i, j)
            elif b_volume and not b_same_time and b_class:                 # case 2
                if n_obs[i] >= n_obs[j] and vol_np[i] > vol_np[j]:
                    kill[j] = True
                    gone[j] = True
                elif n_obs[i] < n_obs[j] and vol_np[i] < vol_np[j]:
                    kill[i] = True
                    gone[i] = True
            elif b_iou and not b_volume and b_same_time and b_class:       # case 3
                # both drop their points inside the other's core region
                shrink_i = 0.5 * (cmax[j] - cmin[j]) - 0.5 * ovl[i, j]
                cj = 0.5 * (cmin[j] + cmax[j])
                evicts.append((i, cj - shrink_i, cj + shrink_i))
                shrink_j = 0.5 * (cmax[i] - cmin[i]) - 0.5 * ovl[i, j]
                ci = 0.5 * (cmin[i] + cmax[i])
                evicts.append((j, ci - shrink_j, ci + shrink_j))
            elif not b_iou and b_volume and b_same_time and not b_class:   # case 4
                big, small = (i, j) if vol_np[i] > vol_np[j] else (j, i)
                evicts.append((big, cmin[small], cmax[small]))
            elif b_iou and not b_same_time and b_class:                    # case 5
                if n_obs[i] // 2 >= n_obs[j]:
                    do_merge(i, j)
                elif n_obs[j] // 2 >= n_obs[i]:
                    do_merge(j, i)

    if not merges and not evicts and not kill.any():
        return m, table, 0, 0
    return (*apply_object_edits(m, table, merges, evicts, kill), len(merges), int(kill.sum()))
