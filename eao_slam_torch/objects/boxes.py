"""Axis-aligned box utilities, batched: pairwise overlaps as [N, M] tensors
(the reference's bboxOverlapratio{,Former,Latter}, include/Converter.h:56-59)
and the 2D detection hygiene pass (src/Tracking.cc:1383-1487). Boxes are
(x, y, w, h) float32."""

from __future__ import annotations

import torch


def box_area(b: torch.Tensor) -> torch.Tensor:
    return torch.clamp(b[..., 2], min=0.0) * torch.clamp(b[..., 3], min=0.0)


def pairwise_intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [N, 4], b: [M, 4] -> [N, M] intersection areas."""
    return intersection_elem(a[:, None, :], b[None, :, :])


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, M] intersection over union."""
    inter = pairwise_intersection(a, b)
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def overlap_former(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, M] intersection / area(a)."""
    return pairwise_intersection(a, b) / torch.clamp(box_area(a)[:, None], min=1e-9)


def overlap_latter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, M] intersection / area(b)."""
    return pairwise_intersection(a, b) / torch.clamp(box_area(b)[None, :], min=1e-9)


def intersection_elem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise (broadcasting) intersection area of (..., 4) boxes."""
    ix0 = torch.maximum(a[..., 0], b[..., 0])
    iy0 = torch.maximum(a[..., 1], b[..., 1])
    ix1 = torch.minimum(a[..., 0] + a[..., 2], b[..., 0] + b[..., 2])
    iy1 = torch.minimum(a[..., 1] + a[..., 3], b[..., 1] + b[..., 3])
    return torch.clamp(ix1 - ix0, min=0.0) * torch.clamp(iy1 - iy0, min=0.0)


def iou_elem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of broadcastable (..., 4) boxes."""
    inter = intersection_elem(a, b)
    return inter / torch.clamp(box_area(a) + box_area(b) - inter, min=1e-9)


def overlap_former_elem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise intersection / area(a)."""
    return intersection_elem(a, b) / torch.clamp(box_area(a), min=1e-9)


def points_in_box(kp: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """kp: [F, 2], boxes: [B, 4] -> [B, F] containment mask (edges inside)."""
    x, y = kp[None, :, 0], kp[None, :, 1]
    x0, y0 = boxes[:, 0, None], boxes[:, 1, None]
    return ((x >= x0) & (x <= x0 + boxes[:, 2, None])
            & (y >= y0) & (y <= y0 + boxes[:, 3, None]))


def bbox_of_points(uv: torch.Tensor, mask: torch.Tensor, width: float,
                   height: float) -> torch.Tensor:
    """Bounding rect, clipped to the image, of masked 2D points: uv
    [..., N, 2], mask [..., N] -> [..., 4] (x, y, w, h). An empty mask gives
    a zero box."""
    big = 1e9
    x0 = torch.clamp(torch.where(mask, uv[..., 0], big).amin(-1), 0.0, width)
    y0 = torch.clamp(torch.where(mask, uv[..., 1], big).amin(-1), 0.0, height)
    x1 = torch.clamp(torch.where(mask, uv[..., 0], -big).amax(-1), 0.0, width)
    y1 = torch.clamp(torch.where(mask, uv[..., 1], -big).amax(-1), 0.0, height)
    any_pt = mask.any(-1)
    zero = torch.zeros_like(x0)
    w = torch.where(any_pt, torch.clamp(x1 - x0, min=0.0), zero)
    h = torch.where(any_pt, torch.clamp(y1 - y0, min=0.0), zero)
    return torch.stack([torch.where(any_pt, x0, zero), torch.where(any_pt, y0, zero), w, h], -1)


def box_hygiene(boxes, cls, score, valid, n_points, width: float, height: float,
                ignore_classes=(0, 63, 15)) -> torch.Tensor:
    """Vectorized 2D detection culling: crowd overlap, ignored classes, too
    large, too few points, few points near the edge, duplicate suppression
    by score, then containment. Two phases (suppression, then containment
    among the survivors), as the reference package does; the C++ sweep's
    outcome depends on its iteration order (src/Tracking.cc:1436-1460)."""
    B = boxes.shape[0]
    ar = torch.arange(B, device=boxes.device)
    not_self = ~torch.eye(B, dtype=torch.bool, device=boxes.device)
    pair_valid = valid[:, None] & valid[None, :] & not_self

    latter = overlap_latter(boxes, boxes)
    crowd = ((latter > 0.05) & pair_valid).sum(1) > 4
    bad = ~valid | crowd
    for c in ignore_classes:
        bad = bad | (cls == c)
    bad = bad | (box_area(boxes) / (width * height) > 0.5)
    bad = bad | (n_points < 5)
    on_edge20 = ((boxes[:, 0] < 20) | (boxes[:, 1] < 20)
                 | (boxes[:, 0] + boxes[:, 2] > width - 20)
                 | (boxes[:, 1] + boxes[:, 3] > height - 20))
    bad = bad | ((n_points < 10) & on_edge20)

    alive = pair_valid & ~bad[:, None] & ~bad[None, :]
    ious = iou(boxes, boxes)
    order = score[:, None] < score[None, :]
    tie = (score[:, None] == score[None, :]) & (ar[:, None] > ar[None, :])
    bad = bad | (alive & (ious > 0.3) & (order | tie)).any(1)
    alive2 = pair_valid & ~bad[:, None] & ~bad[None, :]
    former = overlap_former(boxes, boxes)
    bad = bad | (alive2 & (ious > 0.05) & (former > 0.85)).any(1)
    return ~bad & valid
