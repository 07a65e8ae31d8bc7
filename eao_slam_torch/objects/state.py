"""Fixed-capacity struct-of-arrays object landmark table.

The same 21 fields, shapes and meaning as the reference package's
ObjectTable (the reference's Object_Map list, include/Object.h:160-219).
Point membership lives on the map points (``MapState.pt_object_id`` /
``pt_obj_votes``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ObjectTable(NamedTuple):
    valid: torch.Tensor            # [J] bool slot in use
    bad: torch.Tensor              # [J] bool bBadErase
    cls: torch.Tensor              # [J] i32 class id (-1 empty)
    n_obs: torch.Tensor            # [J] i32 frames observed
    last_frame: torch.Tensor       # [J] i32
    last_last_frame: torch.Tensor  # [J] i32
    last_rect: torch.Tensor        # [J, 4] (x, y, w, h)
    last_last_rect: torch.Tensor   # [J, 4]
    proj_rect: torch.Tensor        # [J, 4] member points' projected rect
    center: torch.Tensor           # [J, 3] mean of member points
    std: torch.Tensor              # [J, 3]
    cent_sum: torch.Tensor         # [J, 3] running sum of per-frame centroids
    cent_sumsq: torch.Tensor       # [J, 3] running sum of squares
    center_std: torch.Tensor       # [J, 3]
    r_max: torch.Tensor            # [J]
    cub_min: torch.Tensor          # [J, 3] object-frame AABB min
    cub_max: torch.Tensor          # [J, 3]
    yaw: torch.Tensor              # [J] rotation about y (0 without line alignment)
    yaw_hist: torch.Tensor         # [J, S, 3] per yaw sample (count, score, error)
    co_occur: torch.Tensor         # [J, J] i32 frames seen together
    re_obj: torch.Tensor           # [J, J] i32 potential-association votes

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


def empty_object_table(max_objects: int, yaw_samples: int = 30, device=None) -> ObjectTable:
    J, S = max_objects, yaw_samples
    i32, f32 = torch.int32, torch.float32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return ObjectTable(
        valid=full((J,), False, torch.bool), bad=full((J,), False, torch.bool),
        cls=full((J,), -1, i32), n_obs=full((J,), 0, i32),
        last_frame=full((J,), -1, i32), last_last_frame=full((J,), -1, i32),
        last_rect=full((J, 4), 0.0, f32), last_last_rect=full((J, 4), 0.0, f32),
        proj_rect=full((J, 4), 0.0, f32),
        center=full((J, 3), 0.0, f32), std=full((J, 3), 0.0, f32),
        cent_sum=full((J, 3), 0.0, f32), cent_sumsq=full((J, 3), 0.0, f32),
        center_std=full((J, 3), 0.0, f32), r_max=full((J,), 0.0, f32),
        cub_min=full((J, 3), 0.0, f32), cub_max=full((J, 3), 0.0, f32),
        yaw=full((J,), 0.0, f32), yaw_hist=full((J, S, 3), 0.0, f32),
        co_occur=full((J, J), 0, i32), re_obj=full((J, J), 0, i32),
    )


def yaw_rotation(yaw: torch.Tensor) -> torch.Tensor:
    """[...] -> [..., 3, 3] rotation about the (downward) y axis."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, zero, s], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([-s, zero, c], -1),
    ], dim=-2)


def cuboid_corners(table: ObjectTable) -> torch.Tensor:
    """[J, 8, 3] world-frame cuboid corners: the AABB of the yaw-rotated
    object frame anchored at the member centroid, x_w = center + R_y(yaw)
    x_obj. Corners 0-3 are the bottom ring (y = min) walking the xz
    rectangle, 4-7 the top ring, so every ring edge is horizontal."""
    lo, hi = table.cub_min, table.cub_max
    xs = torch.stack([lo[:, 0], hi[:, 0], hi[:, 0], lo[:, 0],
                      lo[:, 0], hi[:, 0], hi[:, 0], lo[:, 0]], dim=1)
    ys = torch.stack([lo[:, 1], lo[:, 1], lo[:, 1], lo[:, 1],
                      hi[:, 1], hi[:, 1], hi[:, 1], hi[:, 1]], dim=1)
    zs = torch.stack([lo[:, 2], lo[:, 2], hi[:, 2], hi[:, 2],
                      lo[:, 2], lo[:, 2], hi[:, 2], hi[:, 2]], dim=1)
    corners_obj = torch.stack([xs, ys, zs], dim=-1)
    R = yaw_rotation(table.yaw)
    return table.center[:, None, :] + torch.einsum("jab,jkb->jka", R, corners_obj)
