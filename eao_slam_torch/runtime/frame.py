"""Per-frame observation bundle (geometry fields only)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from eao_slam_torch.config import SystemConfig
from eao_slam_torch.geometry.camera import undistort_points
from eao_slam_torch.ops.orb import extract_orb


class Frame(NamedTuple):
    """One frame's front-end output, padded to capacity F."""

    kp: torch.Tensor      # [F, 2] float32 undistorted pixels
    desc: torch.Tensor    # [F, 8] int32 (uint32 bit pattern)
    octave: torch.Tensor  # [F] int32
    angle: torch.Tensor   # [F] float32 radians
    valid: torch.Tensor   # [F] bool


def pack_descriptors(desc: np.ndarray) -> np.ndarray:
    """[N, 32] uint8 or [N, 8] uint32 -> [N, 8] int32 (same bits)."""
    desc = np.ascontiguousarray(desc)
    if desc.dtype == np.uint8:
        desc = desc.view("<u4").reshape(desc.shape[0], 8)
    return desc.view(np.int32)


def frame_from_arrays(cfg: SystemConfig, kp, desc, octave, valid,
                      angle: Optional[np.ndarray] = None, device=None) -> Frame:
    """A Frame from precomputed front-end arrays (numpy or tensors)."""
    F = cfg.capacity.max_features
    if kp.shape[0] != F:
        raise ValueError(f"expected {F} feature slots, got {kp.shape[0]}")
    if isinstance(desc, np.ndarray):
        desc = pack_descriptors(desc)
    if angle is None:
        angle = np.zeros((F,), np.float32)

    def t(x, dt):
        return torch.as_tensor(np.asarray(x) if isinstance(x, np.ndarray) else x,
                               device=device).to(dt)

    return Frame(kp=t(kp, torch.float32), desc=t(desc, torch.int32),
                 octave=t(octave, torch.int32), angle=t(angle, torch.float32),
                 valid=t(valid, torch.bool))


def frame_from_image(cfg: SystemConfig, img, device) -> Frame:
    """Run the ORB front end on one grayscale image [H, W] (0..255) and
    package the result, padded or cut to capacity."""
    img = torch.as_tensor(np.asarray(img, np.float32), device=device)
    F = cfg.capacity.max_features
    feats = extract_orb(
        img[None], n_features=F, n_levels=cfg.orb.n_levels,
        scale_factor=cfg.orb.scale_factor,
        threshold=float(cfg.orb.fast_threshold),
        min_threshold=float(cfg.orb.fast_min_threshold),
        border=cfg.orb.edge_threshold,
    )
    kp = undistort_points(cfg.camera, feats.kp[0])
    return Frame(kp=kp, desc=feats.desc[0], octave=feats.octave[0],
                 angle=feats.angle[0], valid=feats.valid[0])
