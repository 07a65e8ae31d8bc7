"""TUM RGB-D sequence contract (numpy): the image list ("timestamp
filename" rows), the ground truth ("timestamp tx ty tz qx qy qz qw" rows,
the camera pose in the gravity-aligned ground frame), the offline
detector's per-frame box files and the t-distribution critical-value table
of the EAO object layer (from scipy when no file is given). Lines starting
with '#' are comments."""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np


class ImageList(NamedTuple):
    timestamps: np.ndarray  # [N] float64
    filenames: list         # [N] str, relative to the sequence root


def load_image_list(path: str) -> ImageList:
    ts, names = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ts.append(float(parts[0]))
            names.append(parts[1])
    return ImageList(np.asarray(ts, np.float64), names)


class GroundTruth(NamedTuple):
    timestamps: np.ndarray  # [N] float64
    t_wc: np.ndarray        # [N, 3]
    q_wc: np.ndarray        # [N, 4] wxyz (the file stores xyzw)


def load_groundtruth(path: str) -> GroundTruth:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    arr = np.asarray(rows, np.float64)
    return GroundTruth(arr[:, 0], arr[:, 1:4], arr[:, [7, 4, 5, 6]])


def lookup_pose(gt: GroundTruth, timestamp: float, tol: float = 0.05):
    """The ground-truth row nearest ``timestamp``: (t, q wxyz), or None
    when it is more than ``tol`` seconds away."""
    i = int(np.argmin(np.abs(gt.timestamps - timestamp)))
    if abs(gt.timestamps[i] - timestamp) > tol:
        return None
    return gt.t_wc[i], gt.q_wc[i]


def pose_from_tq(t, q_wxyz) -> np.ndarray:
    """(t, q wxyz) -> [3, 4] float64 camera-in-world (T_wc) matrix; the
    quaternion is normalised first."""
    w, x, y, z = (float(v) for v in q_wxyz)
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)
    return np.concatenate([R, np.asarray(t, np.float64)[:, None]], axis=1)


def lookup_pose_matrix(gt: GroundTruth, timestamp: float,
                       tol: float = 0.05) -> Optional[np.ndarray]:
    """The nearest ground-truth pose as a [3, 4] T_wc matrix, or None."""
    hit = lookup_pose(gt, timestamp, tol)
    return None if hit is None else pose_from_tq(hit[0], hit[1])


def load_yolo_boxes(yolo_dir: str, timestamp: float, max_boxes: int,
                    im_width: int = 640, im_height: int = 480, min_score: float = 0.0):
    """One frame's offline detections, ``<yolo_dir>/<timestamp:.6f>.txt``
    with one ``class x y w h score`` line per box, into fixed-size padded
    arrays: (boxes [max_boxes, 4] xywh float32, class int32, score float32,
    valid bool). Boxes are clamped to the image; boxes of 2 pixels or less
    after clamping, or under ``min_score``, are dropped. A missing file
    gives no boxes."""
    boxes = np.zeros((max_boxes, 4), np.float32)
    cls = np.full((max_boxes,), -1, np.int32)
    score = np.zeros((max_boxes,), np.float32)
    valid = np.zeros((max_boxes,), bool)
    fname = os.path.join(yolo_dir, f"{timestamp:.6f}.txt")
    if not os.path.exists(fname):
        return boxes, cls, score, valid
    n = 0
    with open(fname) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6 or n >= max_boxes:
                continue
            c = int(float(parts[0]))
            x, y, w, h = (float(v) for v in parts[1:5])
            s = float(parts[5])
            if s < min_score:
                continue
            x = max(0.0, x)
            y = max(0.0, y)
            w = min(w, im_width - x)
            h = min(h, im_height - y)
            if w <= 2 or h <= 2:
                continue
            boxes[n] = (x, y, w, h)
            cls[n] = c
            score[n] = s
            valid[n] = True
            n += 1
    return boxes, cls, score, valid


def load_t_table(path: Optional[str] = None) -> np.ndarray:
    """The t-distribution critical-value table, [rows, 9] float32 in the
    layout of the reference's data/t_test.txt: row 0 the alpha header
    (0.5 0.4 0.2 0.1 0.05 0.025 0.01 0.001), then one row per degree of
    freedom, [dof, t(alpha_0), ..., t(alpha_7)], so ``table[dof, col]``
    indexes it directly. Without a file: 121 rows of two-sided critical
    values from ``scipy.stats.t``."""
    if path is not None and os.path.exists(path):
        rows = []
        with open(path) as f:
            for line in f:
                vals = [float(v) for v in line.split()]
                if vals:
                    rows.append(vals)
        width = max(len(r) for r in rows)
        out = np.zeros((len(rows), width), np.float32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    from scipy.stats import t as t_dist

    alphas = np.array([0.5, 0.4, 0.2, 0.1, 0.05, 0.025, 0.01, 0.001])
    out = np.zeros((122, 9), np.float32)
    out[0, 1:] = alphas
    for dof in range(1, 122):
        out[dof, 0] = dof
        out[dof, 1:] = t_dist.ppf(1.0 - alphas / 2.0, dof)
    return out
