"""KITTI odometry sequence loading (the mono_kitti driver's contract).

Timestamps from ``<seq>/times.txt`` (one float per line, seconds) and
frames at ``<seq>/image_2/%06d.png`` (Examples/Monocular/mono_kitti.cc
LoadImages). The camera preset follows the sequence number
(KITTI00-02 / KITTI03 / KITTI04-12).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from eao_slam_torch.geometry.camera import KITTI00_02, KITTI03, KITTI04_12, Camera


class ImageList(NamedTuple):
    timestamps: np.ndarray   # [N] float64 seconds
    filenames: list          # [N] paths relative to the sequence directory


def load_kitti_sequence(seq_dir: str, image_dir: str = "image_2") -> ImageList:
    """times.txt and the image_2/%06d.png listing; blank lines skipped."""
    ts = []
    with open(os.path.join(seq_dir, "times.txt")) as f:
        for line in f:
            line = line.strip()
            if line:
                ts.append(float(line.split()[0]))
    names = [os.path.join(image_dir, "%06d.png" % i) for i in range(len(ts))]
    return ImageList(np.asarray(ts, np.float64), names)


def kitti_camera(sequence: int | str) -> Camera:
    """Sequence number -> intrinsics preset."""
    n = int(sequence)
    if 0 <= n <= 2:
        return KITTI00_02
    if n == 3:
        return KITTI03
    if 4 <= n <= 12:
        return KITTI04_12
    raise ValueError(f"unknown KITTI odometry sequence {sequence}")
