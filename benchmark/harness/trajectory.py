"""The benchmark's frozen trajectory and object arithmetic (numpy only).

``map_object_errors`` is copied from the port's ``io/trajectory.py`` so
that later changes to the port do not move the yardstick;
``relative_motion_errors`` and ``aligned_error_share`` are the benchmark's
own.
"""

from __future__ import annotations

import numpy as np


def map_object_errors(m, table, ts, gt, scene_centers, scene_classes) -> list:
    """For each scene object, the distance of the nearest estimated object of
    its class from it, read in the camera frames of the keyframes that
    observed that object, at the map's own scale.

    m, table: a tracker's final map and object table, their fields by name
    as numpy arrays (a MapState / ObjectTable of either package,
    converted); ts, gt: the sequence's timestamps and true camera-from-
    world poses; a keyframe's truth is the pose nearest its timestamp. A
    live object j (valid, not bad) is observed by keyframe k when k sees
    one of its member points; there its centre lies at R_k c_j + t_k in
    map units, and the scene object of its class at R*_k c* + t*_k in
    metres. The run's one scale is the median ratio of the true to the
    estimated distance over all such (object, keyframe) pairs; an object's
    error is the median over its keyframes of the distance between the
    scaled and the true point. No trajectory alignment enters: a monocular
    map's scale drifts, and one sim3 of a short keyframe arc misplaces
    objects metres away. A scene object without an observed object of its
    class reads inf. The scene's classes must be distinct."""
    scene_classes = np.asarray(scene_classes)
    if len(np.unique(scene_classes)) != len(scene_classes):
        raise ValueError("scene object classes must be distinct")
    kv = m["kf_valid"]
    kf_T = m["kf_pose"][kv].astype(np.float64)
    kf_gt = gt[[int(np.argmin(np.abs(ts - t))) for t in m["kf_timestamp"][kv]]]
    kf_pt_idx = m["kf_pt_idx"][kv]
    pt_object = np.where(m["pt_valid"], m["pt_object_id"], -1)
    obj_of_feat = np.where(kf_pt_idx >= 0, pt_object[np.maximum(kf_pt_idx, 0)], -1)
    centers = table["center"].astype(np.float64)
    pairs = []
    for j in np.flatnonzero(table["valid"] & ~table["bad"]):
        seen = (obj_of_feat == j).any(1)
        g = np.flatnonzero(scene_classes == table["cls"][j])
        if not seen.any() or len(g) == 0:
            continue
        est = kf_T[seen, :, :3] @ centers[j] + kf_T[seen, :, 3]
        true = kf_gt[seen, :, :3] @ np.asarray(scene_centers[g[0]], np.float64) + kf_gt[seen, :, 3]
        pairs.append((int(g[0]), est, true))
    errs = [float("inf")] * len(scene_classes)
    if not pairs:
        return errs
    scale = np.median(np.concatenate([np.linalg.norm(t, axis=1) / np.linalg.norm(e, axis=1)
                                      for _, e, t in pairs]))
    for g, est, true in pairs:
        errs[g] = min(errs[g], float(np.median(np.linalg.norm(scale * est - true, axis=1))))
    return errs



def _rot_angle_deg(R: np.ndarray) -> np.ndarray:
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def relative_motion_errors(T_est: np.ndarray, T_gt: np.ndarray, k: int) -> tuple:
    """Per pair of frames (i, i + k): the angle in degrees between the
    estimated and the true rotation of the camera's motion from frame i to
    frame i + k, and between the directions of its translation. T_est,
    T_gt: [n, 3, 4] camera-from-world poses, NaN where a frame has none.
    A motion R_i+k R_i^T, t_i+k - R_i+k R_i^T t_i is the same whatever
    the world's frame and its scale, so no alignment enters and a monocular
    map's scale drift does not count. Pairs with a frame without a pose
    read NaN."""
    def motion(T):
        R, t = T[:, :, :3], T[:, :, 3]
        R_rel = R[k:] @ np.swapaxes(R[:-k], 1, 2)
        t_rel = t[k:] - np.einsum("nij,nj->ni", R_rel, t[:-k])
        return R_rel, t_rel

    Re, te = motion(np.asarray(T_est, np.float64))
    Rg, tg = motion(np.asarray(T_gt, np.float64))
    rot = _rot_angle_deg(Re @ np.swapaxes(Rg, 1, 2))
    # a motion without translation reads as at right angles to the truth;
    # one under 1e-5 of the camera's distance from the world's origin is
    # the float32 rounding of R_rel t_i on a pose that did not move (a real
    # motion over a few frames is some 1e-2 of it)
    T_e = np.asarray(T_est, np.float64)
    still = np.linalg.norm(te, axis=1) <= 1e-5 * np.linalg.norm(T_e[:-k, :, 3], axis=1)
    norms = np.where(still, 0.0, np.linalg.norm(te, axis=1)) * np.linalg.norm(tg, axis=1)
    cos = np.einsum("ni,ni->n", te, tg) / np.where(norms > 0, norms, np.inf)
    return rot, np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def aligned_error_share(T_est: np.ndarray, T_gt: np.ndarray) -> float:
    """The tracked frames' camera centres against the true ones after the
    similarity (rotation, translation, scale; Umeyama) that fits them best:
    the RMS of what is left, over the RMS distance of the true centres from
    their mean. T_est, T_gt: [n, 3, 4] camera-from-world poses, NaN where a
    frame has none. Free of the map's frame and scale; a camera that does
    not move reads 1, one that follows the truth exactly 0; inf with fewer
    than 3 tracked frames."""
    ok = np.isfinite(T_est).all(axis=(1, 2))
    if ok.sum() < 3:
        return float("inf")

    def centres(T):
        T = np.asarray(T, np.float64)
        return -np.einsum("nji,nj->ni", T[:, :, :3], T[:, :, 3])

    a, b = centres(T_est[ok]), centres(T_gt[ok])
    xa, xb = a - a.mean(0), b - b.mean(0)
    U, S, Vt = np.linalg.svd(xb.T @ xa / len(a))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    var = (xa ** 2).sum(1).mean()
    scale = np.trace(np.diag(S) @ D) / var if var > 0 else 0.0
    resid = scale * xa @ (U @ D @ Vt).T - xb
    return float(np.sqrt((resid ** 2).sum(1).mean() / (xb ** 2).sum(1).mean()))
