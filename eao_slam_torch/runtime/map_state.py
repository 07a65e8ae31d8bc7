"""Struct-of-arrays map state: fixed-capacity tensors plus validity masks.

Same fields, shapes and meaning as the reference package's MapState;
descriptors are [.., 8] int32 holding the uint32 bit pattern.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eao_slam_torch.config import CapacityConfig


class MapState(NamedTuple):
    # keyframes
    kf_pose: torch.Tensor       # [K, 3, 4] camera-from-world
    kf_valid: torch.Tensor      # [K] bool
    kf_timestamp: torch.Tensor  # [K] f32
    kf_frame_id: torch.Tensor   # [K] i32
    kf_kp: torch.Tensor         # [K, F, 2] undistorted keypoints
    kf_desc: torch.Tensor       # [K, F, 8] int32
    kf_octave: torch.Tensor     # [K, F] i32
    kf_angle: torch.Tensor      # [K, F] f32
    kf_kp_valid: torch.Tensor   # [K, F] bool
    kf_pt_idx: torch.Tensor     # [K, F] i32 map point per feature (-1 = none)
    kf_by_object: torch.Tensor  # [K] bool
    # map points
    pt_pos: torch.Tensor        # [P, 3]
    pt_valid: torch.Tensor      # [P] bool
    pt_desc: torch.Tensor       # [P, 8] int32
    pt_normal: torch.Tensor     # [P, 3]
    pt_min_dist: torch.Tensor   # [P]
    pt_max_dist: torch.Tensor   # [P]
    pt_visible: torch.Tensor    # [P] i32
    pt_found: torch.Tensor      # [P] i32
    pt_first_kf: torch.Tensor   # [P] i32
    pt_obs: torch.Tensor        # [P] i32
    pt_object_id: torch.Tensor  # [P] i32
    pt_obj_votes: torch.Tensor  # [P] i32


def empty_map_state(cap: CapacityConfig, device) -> MapState:
    K, F, P = cap.max_keyframes, cap.max_features, cap.max_points
    i32, f32 = torch.int32, torch.float32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        kf_pose=torch.eye(3, 4, dtype=f32, device=device).repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_timestamp=full((K,), 0.0, f32),
        kf_frame_id=full((K,), -1, i32),
        kf_kp=full((K, F, 2), 0.0, f32),
        kf_desc=full((K, F, 8), 0, i32),
        kf_octave=full((K, F), 0, i32),
        kf_angle=full((K, F), 0.0, f32),
        kf_kp_valid=full((K, F), False, torch.bool),
        kf_pt_idx=full((K, F), -1, i32),
        kf_by_object=full((K,), False, torch.bool),
        pt_pos=full((P, 3), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 1e9, f32),
        pt_visible=full((P,), 1, i32),
        pt_found=full((P,), 1, i32),
        pt_first_kf=full((P,), -1, i32),
        pt_obs=full((P,), 0, i32),
        pt_object_id=full((P,), -1, i32),
        pt_obj_votes=full((P,), 0, i32),
    )
