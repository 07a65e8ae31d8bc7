"""What decides ``correct``: the numbers a run compares, each against the
limit in ``benchmark/limits/<cell>.json`` (a number passes when it is at
most its limit), and the import guard.

Numbers:
    frontend_kp_diff     share of the sampled frames' keypoints (octave, level
                         pixel) that the program and the plain reference
                         (``reference/orb.py``) do not both select
    frontend_desc_diff   share of descriptor bits that differ on the
                         keypoints both select
    untracked_share      share of the window's frames with no pose
    motion_rot_err_deg   mean over the window's pairs of frames 4 apart of
                         the angle between the estimated and the true
                         rotation of the camera's motion between them
                         (``trajectory.relative_motion_errors``)
    motion_dir_err_deg   the same for the direction of its translation
    trajectory_err_share the window's camera centres against the true ones
                         after the similarity that fits them best: the RMS
                         of what is left over the RMS spread of the truth
                         (``trajectory.aligned_error_share``; 1 for a
                         camera that does not move)
    objects_missing      scene objects that the boxes showed and that have
                         no live object of their class seen from a keyframe
                         (object modes)
    object_err_m         the worst such object's centre error
                         (``trajectory.map_object_errors``; object modes)

A run computes each number its mode has; a cell compares those its limits
file names.
"""

from __future__ import annotations

import math
import sys

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "eao_slam_tpu")


def forbidden_modules(modules=None) -> list:
    """Modules whose top-level name (the part before the first dot),
    compared whole, is JAX's, jaxlib's, flax's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def _popcount32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    return np.unpackbits(x.view(np.uint8)).reshape(*x.shape, 32).sum(-1)


def frontend_diff(prog: dict, ref: list, scale_factor: float) -> tuple:
    """(kp_diff, desc_diff) of the program's features of C frames (``kp``
    [C, F, 2] x y level-0 pixels, ``desc`` [C, F, 8] int32, ``octave``,
    ``valid`` [C, F]) against the reference's per-level output for the same
    frames (``reference.orb.extract``)."""
    missing = total = common = bits = 0
    C = prog["kp"].shape[0]
    for c in range(C):
        v = prog["valid"][c]
        o = prog["octave"][c][v].astype(np.int64)
        s = scale_factor ** o.astype(np.float64)
        x = np.rint(prog["kp"][c][v][:, 0] / s).astype(np.int64)
        y = np.rint(prog["kp"][c][v][:, 1] / s).astype(np.int64)
        kp = (o << 24) | (y << 12) | x
        kr = np.concatenate([(l << 24) | (r["yx"][c][r["valid"][c]][:, 0] << 12)
                             | r["yx"][c][r["valid"][c]][:, 1] for l, r in enumerate(ref)])
        dr = np.concatenate([r["desc"][c][r["valid"][c]] for r in ref])
        both, ip, ir = np.intersect1d(kp, kr, assume_unique=True, return_indices=True)
        n = max(len(kp), len(kr))
        total += n
        missing += n - len(both)
        common += len(both)
        bits += int(_popcount32(prog["desc"][c][v][ip] ^ dr[ir]).sum())
    kp_diff = missing / total if total else 1.0
    desc_diff = bits / (256 * common) if common else 1.0
    return kp_diff, desc_diff


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every limited number present,
    finite and at most its limit."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        value = None if value is None else float(value)
        ok = ok and value is not None and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit}
    return bool(ok), out
