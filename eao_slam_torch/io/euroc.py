"""EuRoC MAV sequence loading (the mono_euroc driver's contract).

A timestamp file (one nanosecond stamp per line, ``#`` comments, the
first comma-separated column) names the frames ``<image_dir>/<stamp>.png``;
without one, the stamps are the names of the PNGs in the directory (the
mav0/cam0/data layout). Timestamps become seconds (stamp / 1e9). The
camera preset is ``geometry.camera.EUROC`` (radial-tangential
distortion).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np


class ImageList(NamedTuple):
    timestamps: np.ndarray   # [N] float64 seconds
    filenames: list          # [N] names relative to the image directory


def load_euroc_sequence(image_dir: str, times_path: Optional[str] = None) -> ImageList:
    if times_path is not None:
        stamps = []
        with open(times_path) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    stamps.append(line.split(",")[0].split()[0])
    else:
        stamps = sorted(os.path.splitext(n)[0] for n in os.listdir(image_dir)
                        if n.endswith(".png"))
    ts = np.asarray([float(s) for s in stamps], np.float64) / 1e9
    return ImageList(ts, [s + ".png" for s in stamps])
