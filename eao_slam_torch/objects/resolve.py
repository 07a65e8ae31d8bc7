"""The ensemble cascade's decisions, on the device.

The cascade (Object_2D::ObjectDataAssociation, src/Object.cc:162-710) is
first-success sequential per detection with a shared ``taken`` set. As the
reference package's ``resolve_cascade`` does with a ``fori_loop``, this is
a loop over the B <= 16 detections on tensors, with no host readback
inside: every stage is a masked argmax or a newest-first pick over [J]
score rows that ``compute_detection_stats`` precomputed, and the
potential-association votes (mReObj) gather into a [J, J] increment.

  stage 1  IoU vs motion-predicted box, per-object threshold 0.5 / 0.6
  stage 2  Wilcoxon rank-sum pass, newest-first, sanity-gated
  stage 3  projected-box IoU argmax (skipped when npts >= 10 and n_obs > 8)
  stage 4  per-axis t-test vs the t-table, alpha 0.05 / relaxed 0.001,
           newest-first, sanity-gated
then a new object for an unassociated detection away from the border.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eao_slam_torch.objects.association import FrameDetections
from eao_slam_torch.objects.state import ObjectTable


class ResolveResult(NamedTuple):
    assoc: torch.Tensor      # [B] i32 associated slot or -1
    new_slots: torch.Tensor  # [B] i32 allocated new-object slot or -1
    re_inc: torch.Tensor     # [J, J] i32 mReObj vote increments


def _highest_true(mask: torch.Tensor) -> torch.Tensor:
    """Highest index where mask is True, or -1 (the reference iterates the
    object vector newest-first)."""
    J = mask.shape[0]
    j = J - 1 - torch.argmax(mask.flip(0).to(torch.uint8))
    return torch.where(mask.any(), j, -1)


def resolve_cascade(det: FrameDetections, table: ObjectTable, t_table: torch.Tensor, bxs,
                    proj_iou_threshold: float, use_iou: bool = True, use_nonparam: bool = True,
                    use_ttest: bool = True, img_w: int = 640, img_h: int = 480,
                    min_points: int = 5) -> ResolveResult:
    """t_table: [122, 9] critical values on the device (data/t_test.txt
    layout); bxs: [B, 4]. The use_* switches are the DemoFlag's stages."""
    B = det.det_valid.shape[0]
    J = table.capacity
    dev = bxs.device
    jidx = torch.arange(J, device=dev)
    minus1 = torch.tensor(-1, device=dev)

    tab_valid = table.valid & ~table.bad
    n_obs = table.n_obs
    crit_row = torch.clamp(n_obs - 1, 1, 121).long()
    t_crit_5 = t_table[crit_row, 5]      # alpha 0.05
    t_crit_8 = t_table[crit_row, 8]      # alpha 0.001
    sanity = (det.sanity_iou >= 0.5) | (det.sanity_former >= 0.8)     # [B, J]
    x, y, w, h = bxs.unbind(1)
    edge = (x < 10) | (y < 10) | (x + w > img_w - 10) | (y + h > img_h - 10)

    taken = torch.zeros(J, dtype=torch.bool, device=dev)
    assoc, rows, new_mask = [], [], []
    for b in range(B):
        # invalid detections contribute no stages, no votes, no objects
        cand = tab_valid & det.class_ok[b] & ~taken & det.det_valid[b]
        got = minus1
        row = torch.zeros(J, dtype=torch.int32, device=dev)

        if use_iou:
            s1 = torch.where(cand & (det.iou_pred[b] > det.iou_thresh), det.iou_pred[b], 0.0)
            j1 = torch.argmax(s1)          # ties: the lowest index, as jnp.argmax
            got = torch.where(s1[j1] > 0, j1, got)

        if use_nonparam:
            np_c = cand & det.np_pass[b] & det.np_n_ok & det.np_m_ok[b]
            got = torch.where(got < 0, _highest_true(np_c & sanity[b]), got)
            row = row + ((got >= 0) & np_c & (jidx != got)).to(torch.int32)

        if use_ttest:
            skip = (det.det_npts[b] >= 10) & (n_obs > 8)
            pj = cand & ~skip & (det.proj_iou[b] >= proj_iou_threshold)
            s3 = torch.where(pj, det.proj_iou[b], 0.0)
            j3 = torch.argmax(s3)
            got = torch.where((got < 0) & (s3[j3] > 0), j3, got)
            row = row + ((got >= 0) & pj & (jidx != got)).to(torch.int32)

            tv = det.t_vals[b]                                       # [J, 3]
            df_ok = cand & (n_obs > 8)
            strong = df_ok & (tv < t_crit_5[:, None]).all(1)
            relax = df_ok & (det.proj_iou[b] > 0.25) & (
                (tv < t_crit_8[:, None]).all(1) | (tv.mean(1) < 10.0))
            lower = df_ok & ~strong & ~relax & (det.proj_iou[b] > 0.25)
            t_c = strong | relax
            got = torch.where(got < 0, _highest_true(t_c & sanity[b]), got)
            row = row + ((got >= 0) & (t_c | lower) & (jidx != got)).to(torch.int32)

        got = torch.where(det.det_valid[b], got, minus1)
        taken = taken | ((jidx == got) & (got >= 0))
        assoc.append(got)
        rows.append(row)
        # a new object unless the box hugs the image border
        new_mask.append(det.det_valid[b] & (got < 0) & ~edge[b]
                        & (det.det_npts[b] >= min_points))
    assoc = torch.stack(assoc).to(torch.int32)
    new_mask = torch.stack(new_mask)
    # rows of unassociated detections go to a dropped row; associated
    # detections target distinct objects
    re_inc = torch.zeros((J + 1, J), dtype=torch.int32, device=dev).index_add_(
        0, torch.where(assoc >= 0, assoc, J).long(), torch.stack(rows))[:J]

    # new objects take the free slots in ascending order
    free_sorted = torch.sort(torch.where(~table.valid, jidx, J)).values
    n_free = (~table.valid).sum()
    rank = torch.cumsum(new_mask.to(torch.int32), 0) - 1
    slot = free_sorted[torch.clamp(rank, 0, J - 1).long()]
    new_slots = torch.where(new_mask & (rank < n_free) & (slot < J), slot, -1).to(torch.int32)
    return ResolveResult(assoc=assoc, new_slots=new_slots, re_inc=re_inc)
