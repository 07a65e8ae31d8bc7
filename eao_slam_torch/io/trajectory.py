"""Trajectory evaluation: ATE RMSE after similarity (Sim3 / Umeyama)
alignment, the standard TUM monocular protocol (numpy only)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning x -> y. x, y: [N, 3].
    Returns (s, R, t) with y ≈ s * R @ x + t."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / len(x)
    s = float(np.trace(np.diag(D) @ S) / var_x) if with_scale else 1.0
    t = my - s * R @ mx
    return s, R, t


def ate_rmse(
    est_t: np.ndarray,
    gt_t: np.ndarray,
    with_scale: bool = True,
) -> float:
    """ATE RMSE after similarity alignment (mono scale is unobservable, so
    scale-aligned comparison matches the standard TUM mono protocol)."""
    s, R, t = umeyama_alignment(est_t, gt_t, with_scale)
    aligned = (s * (R @ est_t.T)).T + t
    err = aligned - gt_t
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


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


def sim3_object_errors(m, table, ts, gt, scene_centers) -> list:
    """The object measure of the reference's tests/test_objects_e2e.py, for
    comparison with ``map_object_errors``: for each scene object, the
    distance of the nearest live object's centre after one sim3 alignment
    of the keyframe camera centres onto ground truth. Arguments as in
    ``map_object_errors``."""
    kv = m["kf_valid"]
    kf_gt = gt[[int(np.argmin(np.abs(ts - t))) for t in m["kf_timestamp"][kv]]]

    def centres(T):
        return np.einsum("nij,ni->nj", -T[:, :, :3], T[:, :, 3])

    s, R, t = umeyama_alignment(centres(m["kf_pose"][kv].astype(np.float64)), centres(kf_gt))
    live = table["valid"] & ~table["bad"]
    if not live.any():
        return [float("inf")] * len(scene_centers)
    w = s * table["center"][live].astype(np.float64) @ R.T + t
    return [float(np.linalg.norm(w - c, axis=1).min()) for c in scene_centers]
