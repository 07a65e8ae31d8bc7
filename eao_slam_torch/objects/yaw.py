"""Object yaw by image-line alignment (Tracking::SampleObjYaw and
AssociateObjAndLines, src/Tracking.cc:2472-2871).

Thirty yaw hypotheses over +-45 degrees rotate an object's cuboid about
the (gravity) y axis. Its three characteristic edges, length (a top
x-edge), width (a top z-edge) and height (a vertical edge), are projected
into the frame, and every detected line inside the detection's box votes
for the hypotheses whose edges it parallels (5 degree gate on the raw
left-to-right angles). The projected edge that is shortest is left out,
except for chairs (class 56), which match all three and weigh the length
edge three times. Each frame casts one vote per object: the sample with
the most parallel lines (ties to the lower mean error, then to the sample
nearer 0), scored (num / nLines) (1 - 0.1 meanErr / 10), or a phantom
vote with 10 degrees of error when no line matches. Votes and running-mean
scores accumulate in ``yaw_hist``; once an object has 3 votes its yaw is
the best-scoring of its 3 most-voted samples.

The per-frame comparison is one [B, S, L] tensor; nothing is read back.
"""

from __future__ import annotations

import numpy as np
import torch

from eao_slam_torch.geometry import se3
from eao_slam_torch.geometry.camera import Camera, project
from eao_slam_torch.objects.association import _top_k
from eao_slam_torch.objects.state import ObjectTable, yaw_rotation

YAW_SAMPLES = 30
# The reference package's grid, jnp.linspace(-45 deg, 45 deg, 30) in
# float32 as XLA computes it (not symmetric to the last bit), and its
# 5-degree gate, as float32 bit patterns.
_YAW_BITS = np.array([
    0xbf490fdb, 0xbf3b3212, 0xbf2d544a, 0xbf1f7681, 0xbf1198b9, 0xbf03baf0,
    0xbeebba51, 0xbecffebe, 0xbeb4432e, 0xbe98879e, 0xbe79981a, 0xbe4220f5,
    0xbe0aa9d6, 0xbda66566, 0xbcdddc80, 0x3cdddc88, 0x3da66568, 0x3e0aa9d7,
    0x3e4220f6, 0x3e799819, 0x3e98879e, 0x3eb4432e, 0x3ecffec0, 0x3eebba51,
    0x3f03baf0, 0x3f1198b9, 0x3f1f7682, 0x3f2d544b, 0x3f3b3212, 0x3f490fdb,
], np.uint32)
ANGLE_GATE = float(np.uint32(0x3db2b8c2).view(np.float32))
CHAIR_CLASS = 56

# characteristic edges as corner index pairs of objects/state.cuboid_corners
# (bottom ring, then top ring): length = top x-edge, width = top z-edge,
# height = a vertical edge (src/Tracking.cc:2689-2723)
EDGE_LEN = (4, 5)
EDGE_WID = (5, 6)
EDGE_HGT = (1, 5)


_GRID_BY_DEVICE = {}


def sample_yaws(device=None) -> torch.Tensor:
    """[30] float32 absolute yaw hypotheses over +-45 degrees
    (src/Tracking.cc:2661). One tensor per device, copied there on first
    use: a copy from host memory on every call would synchronise the
    card's stream twice a frame. Callers must not write to it."""
    dev = torch.device("cpu" if device is None else device)
    if dev not in _GRID_BY_DEVICE:
        _GRID_BY_DEVICE[dev] = torch.from_numpy(_YAW_BITS.view(np.float32).copy()).to(dev)
    return _GRID_BY_DEVICE[dev]


def lines_in_box(lines: torch.Tensor, line_valid: torch.Tensor, boxes: torch.Tensor,
                 expand: float = 15.0) -> torch.Tensor:
    """[B, L]: both endpoints of a valid line inside the box (x, y, w, h)
    grown by ``expand`` px on every side."""
    x0 = boxes[:, 0:1] - expand
    y0 = boxes[:, 1:2] - expand
    x1 = boxes[:, 0:1] + boxes[:, 2:3] + expand
    y1 = boxes[:, 1:2] + boxes[:, 3:4] + expand

    def inside(px, py):
        return (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)

    m = inside(lines[None, :, 0], lines[None, :, 1]) & inside(lines[None, :, 2], lines[None, :, 3])
    return m & line_valid[None, :]


def _lr_angle(d: torch.Tensor) -> torch.Tensor:
    """Angle of 2D directions (..., 2) taken left to right: (-pi/2, pi/2]."""
    sgn = torch.where(d[..., 0] >= 0, 1.0, -1.0)
    return torch.atan2(sgn * d[..., 1], sgn * d[..., 0])


def yaw_sample_scores(cam: Camera, table: ObjectTable, targets: torch.Tensor,
                      boxes: torch.Tensor, T_cw: torch.Tensor, lines: torch.Tensor,
                      line_valid: torch.Tensor):
    """Per (detection, yaw sample): the number of parallel lines and the sum
    of their angle errors in degrees, and per detection the lines in its
    box. targets [B]: each detection's object slot (-1: inactive); boxes
    [B, 4]; lines [L, 4]. Returns (counts [B, S], errs [B, S], n_lines [B]
    int32)."""
    J = table.capacity
    tj = torch.clamp(targets, 0, J - 1).long()
    lm = lines_in_box(lines, line_valid, boxes) & (targets >= 0)[:, None]
    n_lines = lm.sum(1).to(torch.int32)
    line_ang = _lr_angle(lines[:, 2:4] - lines[:, 0:2])

    lo, hi, ctr = table.cub_min[tj], table.cub_max[tj], table.center[tj]
    xs = torch.stack([lo[:, 0], hi[:, 0], hi[:, 0], lo[:, 0],
                      lo[:, 0], hi[:, 0], hi[:, 0], lo[:, 0]], 1)
    ys = torch.stack([lo[:, 1], lo[:, 1], lo[:, 1], lo[:, 1],
                      hi[:, 1], hi[:, 1], hi[:, 1], hi[:, 1]], 1)
    zs = torch.stack([lo[:, 2], lo[:, 2], hi[:, 2], hi[:, 2],
                      lo[:, 2], lo[:, 2], hi[:, 2], hi[:, 2]], 1)
    corners_obj = torch.stack([xs, ys, zs], -1)                     # [B, 8, 3]
    R = yaw_rotation(sample_yaws(lines.device))                     # [S, 3, 3]
    corners_w = ctr[:, None, None, :] + torch.einsum("sac,bkc->bska", R, corners_obj)
    uv = project(cam, se3.apply(T_cw[None, None, None], corners_w))  # [B, S, 8, 2]

    def edge(pair):
        d = uv[:, :, pair[1], :] - uv[:, :, pair[0], :]
        return _lr_angle(d), torch.linalg.norm(d, dim=-1)           # [B, S]

    (ang1, len1), (ang2, len2), (ang3, len3) = edge(EDGE_LEN), edge(EDGE_WID), edge(EDGE_HGT)
    # raw (unwrapped) angle distances, as the reference compares them
    d1, d2, d3 = (torch.abs(a[:, :, None] - line_ang) for a in (ang1, ang2, ang3))
    shortest = torch.argmin(torch.stack([len1, len2, len3], -1), -1)[:, :, None]
    m1, m2, m3 = d1 < ANGLE_GATE, d2 < ANGLE_GATE, d3 < ANGLE_GATE
    # the shortest projected edge is left out; a line counts if it
    # parallels either remaining edge, its error the nearer of the two
    cnt_gen = torch.where(shortest == 0, (m2 | m3).float(),
                          torch.where(shortest == 1, (m1 | m3).float(), (m1 | m2).float()))
    err_gen = torch.where(shortest == 0, torch.minimum(d2, d3),
                          torch.where(shortest == 1, torch.minimum(d1, d3), torch.minimum(d1, d2)))
    # chairs: width and height edges vote once, the length edge three times
    cnt_chair = (m2 | m3).float() + 3.0 * m1.float()
    err_chair = torch.minimum(d1, torch.minimum(d2, d3))
    is_chair = (table.cls[tj] == CHAIR_CLASS)[:, None, None]
    cnt = torch.where(is_chair, cnt_chair, cnt_gen)
    err = torch.where(is_chair, err_chair, err_gen)

    inbox = lm[:, None, :]
    counts = torch.where(inbox, cnt, 0.0).sum(2)
    errs = torch.rad2deg(torch.where(inbox, err, 0.0).sum(2))
    return counts, errs, n_lines


def update_yaw(table: ObjectTable, targets: torch.Tensor, counts: torch.Tensor,
               errs: torch.Tensor, n_lines: torch.Tensor) -> ObjectTable:
    """One vote per active detection with at least 2 lines in its box, into
    ``yaw_hist`` [J, S, (votes, mean score, mean error)], then the yaw of
    every valid object with 3 or more votes re-elected."""
    J = table.capacity
    dev = counts.device
    active = (targets >= 0) & (n_lines >= 2)
    slot = torch.where(active, torch.clamp(targets, 0, J - 1), J).long()
    yaws = sample_yaws(dev)

    # winner: the most parallel lines; among those the lowest mean error,
    # then the sample nearest 0 (the reference scans from 0 outward)
    err_mean = errs / torch.clamp(counts, min=1.0)
    tie = -1e-4 * torch.abs(yaws)[None, :]
    is_max = counts >= counts.max(1, keepdim=True).values
    win = torch.argmax(torch.where(is_max, -err_mean + tie, -torch.inf), 1)
    num = counts.gather(1, win[:, None])[:, 0]
    e_win = errs.gather(1, win[:, None])[:, 0]
    e_win = torch.where(num > 0, e_win, 10.0)      # phantom vote (src/Tracking.cc:2796)
    num = torch.clamp(num, min=1.0)
    f_err = (e_win / num) / 10.0
    score = (num / torch.clamp(n_lines, min=1)) * (1.0 - 0.1 * f_err)

    # one extra row takes the inactive detections' (zero) updates
    hist = torch.cat([table.yaw_hist, table.yaw_hist.new_zeros((1,) + table.yaw_hist.shape[1:])])
    prev = hist[slot, win]
    times1 = prev[:, 0] + 1.0
    upd = torch.stack([torch.ones_like(score), (score - prev[:, 1]) / times1,
                       (f_err - prev[:, 2]) / times1], -1)
    hist = hist.index_put((slot, win), torch.where(active[:, None], upd, 0.0), accumulate=True)[:J]

    # elect the best mean score among the 3 most-voted samples
    times, sc = hist[..., 0], hist[..., 1]
    _, top3 = _top_k(times, 3)
    sc3 = torch.where(times.gather(1, top3) > 0, sc.gather(1, top3), -1.0)
    best = top3.gather(1, torch.argmax(sc3, 1, keepdim=True))[:, 0]
    enough = times.sum(1) >= 3.0
    return table._replace(yaw_hist=hist, yaw=torch.where(enough & table.valid, yaws[best], table.yaw))
