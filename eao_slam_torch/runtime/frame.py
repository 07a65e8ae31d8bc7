"""Per-frame observation bundle: the front end's features, for the EAO
object layer the offline detector's boxes (the reference's class x y w h
score text contract, src/Tracking.cc:426-499) and, with line-alignment
yaw, the frame's 2D line segments. Geometry mode carries no boxes and a
mode without yaw lines no lines (None)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from eao_slam_torch.config import SystemConfig
from eao_slam_torch.geometry.camera import undistort_points
from eao_slam_torch.ops.lines import detect_segments
from eao_slam_torch.ops.orb import extract_orb


class Frame(NamedTuple):
    """One frame's front-end output, padded to capacity F."""

    kp: torch.Tensor      # [F, 2] float32 undistorted pixels
    desc: torch.Tensor    # [F, 8] int32 (uint32 bit pattern)
    octave: torch.Tensor  # [F] int32
    angle: torch.Tensor   # [F] float32 radians
    valid: torch.Tensor   # [F] bool
    boxes: Optional[torch.Tensor] = None      # [B, 4] float32 (x, y, w, h)
    box_class: Optional[torch.Tensor] = None  # [B] int32 (-1 = empty slot)
    box_score: Optional[torch.Tensor] = None  # [B] float32
    box_valid: Optional[torch.Tensor] = None  # [B] bool
    lines: Optional[torch.Tensor] = None      # [L, 4] float32 (x1, y1, x2, y2)
    line_valid: Optional[torch.Tensor] = None  # [L] bool


def pack_descriptors(desc: np.ndarray) -> np.ndarray:
    """[N, 32] uint8 or [N, 8] uint32 -> [N, 8] int32 (same bits)."""
    desc = np.ascontiguousarray(desc)
    if desc.dtype == np.uint8:
        desc = desc.view("<u4").reshape(desc.shape[0], 8)
    return desc.view(np.int32)


def empty_boxes(cfg: SystemConfig):
    """(boxes, class, score, valid) of a frame without detections."""
    B = cfg.capacity.max_boxes
    return (np.zeros((B, 4), np.float32), np.full((B,), -1, np.int32),
            np.zeros((B,), np.float32), np.zeros((B,), bool))


def empty_lines(cfg: SystemConfig):
    """(lines, valid) of a frame without line segments."""
    L = cfg.capacity.max_lines
    return np.zeros((L, 4), np.float32), np.zeros((L,), bool)


def _t(x, dt, device):
    return torch.as_tensor(np.asarray(x) if isinstance(x, np.ndarray) else x,
                           device=device).to(dt)


def _box_tensors(cfg: SystemConfig, boxes, device):
    """(boxes, class, score, valid) as tensors; None gives empty boxes with
    the object layer on, no boxes without it."""
    if boxes is None and not cfg.flag.objects_enabled:
        return (None,) * 4
    b, c, s, v = empty_boxes(cfg) if boxes is None else boxes
    return (_t(b, torch.float32, device), _t(c, torch.int32, device),
            _t(s, torch.float32, device), _t(v, torch.bool, device))


def _line_tensors(cfg: SystemConfig, lines, line_valid, device):
    """(lines, valid) as tensors; None gives empty lines with line-alignment
    yaw on, no lines without it."""
    if lines is None:
        if not cfg.flag.use_yaw_lines:
            return None, None
        lines, line_valid = empty_lines(cfg)
    return _t(lines, torch.float32, device), _t(line_valid, torch.bool, device)


def frame_from_arrays(cfg: SystemConfig, kp, desc, octave, valid,
                      angle: Optional[np.ndarray] = None, device=None,
                      boxes=None, lines=None, line_valid=None) -> Frame:
    """A Frame from precomputed front-end arrays (numpy or tensors);
    ``boxes`` = (boxes [B, 4], class [B], score [B], valid [B]) or None
    (a frame without detections); ``lines`` [L, 4] and ``line_valid`` [L]
    or None (a frame without line segments)."""
    F = cfg.capacity.max_features
    if kp.shape[0] != F:
        raise ValueError(f"expected {F} feature slots, got {kp.shape[0]}")
    if isinstance(desc, np.ndarray):
        desc = pack_descriptors(desc)
    if angle is None:
        angle = np.zeros((F,), np.float32)
    return Frame(_t(kp, torch.float32, device), _t(desc, torch.int32, device),
                 _t(octave, torch.int32, device), _t(angle, torch.float32, device),
                 _t(valid, torch.bool, device), *_box_tensors(cfg, boxes, device),
                 *_line_tensors(cfg, lines, line_valid, device))


def frame_from_image(cfg: SystemConfig, img, device, boxes=None) -> Frame:
    """Run the ORB front end on one grayscale image [H, W] (0..255) and
    package the result, padded or cut to capacity, with ``boxes`` as in
    ``frame_from_arrays``; with line-alignment yaw on, the image's line
    segments too."""
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
    lines = (None, None)
    if cfg.flag.use_yaw_lines:
        lines = detect_segments(img, max_lines=cfg.capacity.max_lines)
    return Frame(kp, feats.desc[0], feats.octave[0], feats.angle[0], feats.valid[0],
                 *_box_tensors(cfg, boxes, device), *lines)
