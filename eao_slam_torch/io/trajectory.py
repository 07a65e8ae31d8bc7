"""Trajectory export and evaluation (numpy): TUM and KITTI trajectory
files of the camera-in-world poses, ATE RMSE after similarity (Sim3 /
Umeyama) alignment (the standard TUM monocular protocol), and the object
measures of the EAO layer."""

from __future__ import annotations

import numpy as np


def _tum_quaternion(Rwc: np.ndarray) -> np.ndarray:
    """wxyz (w >= 0) of one float64 rotation, by the largest-pivot rule of
    ``geometry.so3.mat_to_quat``, rounded as the TUM files of the
    reference package are: sums and differences of matrix entries in
    float64, each rounded to float32 where it enters an array operation,
    the rest in float32, and the norm accumulated one fused multiply-add
    at a time. Pure numpy: torch's vectorised float32 square root on the
    CPU is not correctly rounded, and one ulp moves a printed digit."""
    f = np.float32
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = Rwc
    tr = m00 + m11 + m22

    def pivot(v):
        q = np.sqrt(np.maximum(f(v), f(1e-12))) * f(0.5)
        return q, f(0.25) / np.maximum(q, f(1e-8))

    qw, s0 = pivot(1.0 + tr)
    qx, s1 = pivot(1.0 + m00 - m11 - m22)
    qy, s2 = pivot(1.0 - m00 + m11 - m22)
    qz, s3 = pivot(1.0 - m00 - m11 + m22)
    cands = (
        (qw, f(m21 - m12) * s0, f(m02 - m20) * s0, f(m10 - m01) * s0),
        (f(m21 - m12) * s1, qx, f(m01 + m10) * s1, f(m02 + m20) * s1),
        (f(m02 - m20) * s2, f(m01 + m10) * s2, qy, f(m12 + m21) * s2),
        (f(m10 - m01) * s3, f(m02 + m20) * s3, f(m12 + m21) * s3, qz),
    )
    pivots = np.array([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], f)
    q = np.array(cands[int(np.argmax(pivots))], f)
    if q[0] < 0:
        q = -q
    acc = f(0.0)
    for v in q.astype(np.float64):
        acc = f(v * v + np.float64(acc))
    return q / (np.sqrt(acc) + f(1e-8))


def save_tum(path: str, timestamps, T_cw, valid=None) -> int:
    """Write "timestamp tx ty tz qx qy qz qw" rows of the camera-in-world
    poses of T_cw [N, 3, 4] (camera-from-world); rows whose ``valid`` is
    False are skipped. Returns the rows written."""
    T_cw = np.asarray(T_cw, np.float64)
    timestamps = np.asarray(timestamps, np.float64)
    n = 0
    with open(path, "w") as f:
        for i in range(len(timestamps)):
            if valid is not None and not valid[i]:
                continue
            Rwc = T_cw[i, :3, :3].T
            twc = -Rwc @ T_cw[i, :3, 3]
            q = _tum_quaternion(Rwc)
            f.write(f"{timestamps[i]:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
            n += 1
    return n


def save_kitti(path: str, T_cw, valid=None) -> int:
    """Write KITTI odometry rows (the 12 values of each 3 x 4 camera-in-world
    matrix), rebased so that the first written pose is the identity.
    Returns the rows written."""
    T_cw = np.asarray(T_cw, np.float64)
    rows = []
    T0wc = None
    for i in range(len(T_cw)):
        if valid is not None and not valid[i]:
            continue
        R = T_cw[i, :3, :3]
        Twc = np.eye(4)
        Twc[:3, :3] = R.T
        Twc[:3, 3] = -R.T @ T_cw[i, :3, 3]
        if T0wc is None:
            T0wc = np.linalg.inv(Twc)
        Twc = T0wc @ Twc
        rows.append(" ".join(f"{v:.9e}" for v in Twc[:3].reshape(-1)))
    with open(path, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
    return len(rows)


def load_kitti_poses(path: str) -> np.ndarray:
    """A KITTI trajectory file back as [N, 3, 4] camera-in-world poses."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) == 12:
                rows.append(np.asarray(vals).reshape(3, 4))
    return np.stack(rows) if rows else np.zeros((0, 3, 4))


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


def associate_by_time(ts_a: np.ndarray, ts_b: np.ndarray, tol: float = 0.05):
    """Nearest-timestamp association: (i, j) index pairs [M, 2] for every
    ts_a[i] whose nearest ts_b[j] is within ``tol``."""
    pairs = []
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        if abs(ts_b[j] - ta) <= tol:
            pairs.append((i, j))
    return np.asarray(pairs, np.int64).reshape(-1, 2)


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


def object_yaws(table) -> list:
    """Each live object's slot, class, elected yaw in degrees, yaw votes
    (the sum of its ``yaw_hist`` counts) and cuboid bounds in its own frame
    (``cub_min``, ``cub_max``, metres), in slot order. ``table``: an
    ObjectTable's fields by name as numpy arrays, of either package."""
    live = table["valid"] & ~table["bad"]
    return [{"slot": int(j), "cls": int(table["cls"][j]),
             "yaw_deg": float(np.rad2deg(table["yaw"][j])),
             "votes": float(table["yaw_hist"][j, :, 0].sum()),
             "cub_min": [float(v) for v in table["cub_min"][j]],
             "cub_max": [float(v) for v in table["cub_max"][j]]} for j in np.flatnonzero(live)]
